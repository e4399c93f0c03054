"""Block-cull closest hit: the scale path (PyTorch port of
``simple_spectral_tpu.render.cull``) and the wrapper of kernel K2.

Three stages, as in the JAX package:

1. **Host build** (:func:`build_cluster_arrays`): the binned-SAH splits of
   render/bvh.py cut the primitives into C clusters of at most L = 63,
   packed one tile per cluster, f32[C, 1 + L, 128]: row 0 holds the
   cluster's AABB (words 2..7), rows 1..L the primitives in the bvh row
   layout (word 0 kind, words 2..10 payload, word 11 prim id), short
   clusters padded with kind -1 rows.  The 128-word row width is the TPU's
   alignment, kept so that the leaves equal the JAX package's; the kernel
   reads 12 words of each row.
2. **Cull** (:func:`cull_lists`, plain torch): a dense [C, lanes] slab test,
   and for every block of BLOCK_N = 1024 lanes the clusters hit by any of
   its lanes, front to back by the block's least entry distance (a stable
   sort, as ``jnp.argsort`` is), with those entry distances.
3. **Test** (:func:`cull_best`): each block walks its list, prunes each lane
   against its running best with the cluster's AABB, tests the cluster's
   rows (watertight triangle test, nearest sphere root) and keeps a per-lane
   key ``(bits(dist) & ~63) | row`` and flat slot ``c * (1 + L) + 1 + row``,
   updated only on a strict ``<``.  The winner is the lexicographic least
   (quantized distance, list position, row).  On the card this is kernel K2
   (``csrc/cull_best.cu``), in which each warp walks its block's list by
   itself and stops once the next entry distance exceeds the best key of
   every real lane of the warp: a cluster that far away fails the AABB
   prune of each of those lanes, so the cut changes no result.  On the CPU
   it is :func:`cull_best_plain`, which walks every listed cluster, or, given
   ``entries`` and ``group``, stops each group of lanes by the same vote.
   :func:`cull_work` counts the work an exact walk of given inputs needs,
   for the kernel's bound.

:func:`intersect_rays_cull` runs the three on a batch of rays, optionally in
a spatial (origin Morton cell, direction octant) order, and recovers the
winners' attributes (render/bvh.py ``recover_hit_record``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from simple_spectral_torch import kernels
from simple_spectral_torch.render.bvh import KIND_SPHERE, KIND_TRI, ROW_WIDTH, _split_sah, primitive_bounds
from simple_spectral_torch.render.vec import V3, select3
from simple_spectral_torch.tools import OPS_PER_TRIANGLE_TEST

BLOCK_N = 1024
INF_BITS = 0x7F800000
TILE_W = 128
# Lanes per piece of the stage-2 slab cull, a multiple of BLOCK_N: one
# [C, STAGE2_LANES] f32 array is 316 MB at C = 1205.  The lists are per
# block, so the pieces give the same lists as one pass.
STAGE2_LANES = 1 << 16
# Cluster count from which intersect_rays_cull sorts its rays by default
# (the JAX package's C >= 192).
SORT_MIN_CLUSTERS = 192

# FP32 operations of one lane's AABB slab test (6 subtractions, 6 products,
# 10 min/max) and of one sphere row (3 + 1 + 5 + 6 + 2 + 1 sqrt + 3); a
# triangle row is OPS_PER_TRIANGLE_TEST.
SLAB_OPS = 22
SPHERE_OPS = 21
# Lanes of one warp of K2: the lanes that stop their walk together.
WARP = 32

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("cull_best.cu")
# cull_best_launch(tiles, c_total, rows, tile_w, counts, lists, entries,
# rays, n_pad, n_valid, eps, out, visits, stream)
_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
             + [ctypes.c_float] + [ctypes.c_void_p] * 3)


def build_cluster_arrays(
    tri_verts: np.ndarray,
    tri_prim: np.ndarray,
    tri_mat: np.ndarray,
    sphere_center: Optional[np.ndarray] = None,
    sphere_radius: Optional[np.ndarray] = None,
    sphere_prim: Optional[np.ndarray] = None,
    sphere_mat: Optional[np.ndarray] = None,
    cluster_size: int = 63,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SAH-partitioned cluster tiles (stage 1).

    Returns (tiles f32[C, 1 + L, TILE_W], entry_ref i32[C * (1 + L)],
    entry_mat i32[C * (1 + L)]); the flat entry arrays run parallel to
    ``tiles.reshape(-1, TILE_W)``, so a winning slot indexes them directly."""
    assert 1 <= cluster_size <= 63  # the row index must fit 6 key bits
    tri_verts = np.asarray(tri_verts, np.float64)
    t, mn, mx, cent, prim_id, mat_id = primitive_bounds(
        tri_verts, tri_prim, tri_mat, sphere_center, sphere_radius, sphere_prim, sphere_mat)

    clusters = []
    stack = [np.arange(mn.shape[0], dtype=np.int64)]
    while stack:
        idxs = stack.pop()
        if len(idxs) <= cluster_size:
            clusters.append(idxs)
            continue
        left, right = _split_sah(idxs, cent, mn, mx)
        stack.append(right)
        stack.append(left)

    c = len(clusters)
    l = cluster_size
    rows = np.zeros((c, 1 + l, TILE_W), np.float32)
    rows_i = rows.view(np.int32)
    ref = np.full(c * (1 + l), -1, np.int32)
    mat = np.zeros(c * (1 + l), np.int32)
    for ci, idxs in enumerate(clusters):
        rows[ci, 0, 2:5] = mn[idxs].min(axis=0)
        rows[ci, 0, 5:8] = mx[idxs].max(axis=0)
        rows_i[ci, 1:, 0] = -1  # padding kind
        for ri, gi in enumerate(idxs):
            slot = ci * (1 + l) + 1 + ri
            if gi < t:
                rows_i[ci, 1 + ri, 0] = KIND_TRI
                rows[ci, 1 + ri, 2:11] = tri_verts[gi].reshape(9)
                ref[slot] = gi
            else:
                rows_i[ci, 1 + ri, 0] = KIND_SPHERE
                rows[ci, 1 + ri, 2:5] = np.asarray(sphere_center, np.float32)[gi - t]
                rows[ci, 1 + ri, 5] = np.asarray(sphere_radius, np.float32)[gi - t]
                ref[slot] = gi - t
            rows_i[ci, 1 + ri, 11] = int(prim_id[gi])
            mat[slot] = int(mat_id[gi])
    return rows, ref, mat


def _inv_safe(c: torch.Tensor) -> torch.Tensor:
    """1/c with |c| < 1e-30 replaced by 1e-30: slab distances stay finite and
    keep the right containment sense for axis-parallel rays."""
    return 1.0 / torch.where(torch.abs(c) < 1e-30, 1e-30, c)


def cull_rays(o: V3, d: V3, ignore_prim: torch.Tensor) -> torch.Tensor:
    """Rays f32[8, Np] as stages 2 and 3 take them: ox oy oz dx dy dz, the
    ignored prim id's bits, 0; padded to a whole number of blocks with lanes
    that start far outside every AABB and point away (they miss)."""
    n = o.x.shape[0]
    n_pad = -(-n // BLOCK_N) * BLOCK_N
    rays = torch.empty((8, n_pad), dtype=torch.float32, device=o.x.device)
    fill = (1e9, 1e9, 1e9, 1.0, 0.0, 0.0)
    for r, (x, f) in enumerate(zip((o.x, o.y, o.z, d.x, d.y, d.z), fill)):
        rays[r, :n] = x
        rays[r, n:] = f
    rays[6].view(torch.int32)[:n] = ignore_prim.to(torch.int32)
    rays[6].view(torch.int32)[n:] = -1
    rays[7] = 0.0
    return rays


def cull_lists(tiles: torch.Tensor, rays: torch.Tensor, eps: float):
    """Stage 2: tiles f32[C, 1+L, W], rays f32[8, Np] -> (counts i32[NB],
    lists i32[NB, C], entries f32[NB, C]).  Block b tests lists[b, :counts[b]],
    ascending in entries (the block's least max(tn, 0) over its lanes that
    hit the AABB; inf past the count)."""
    eps = float(np.float32(eps))
    c_total = tiles.shape[0]
    n_pad = rays.shape[1]
    c_mn = tiles[:, 0, 2:5]
    c_mx = tiles[:, 0, 5:8]
    hit_parts, key_parts = [], []
    for lo in range(0, n_pad, STAGE2_LANES):
        r = rays[:, lo:lo + STAGE2_LANES]
        nb = r.shape[1] // BLOCK_N

        def slab(axis):
            ov, iv = r[axis], _inv_safe(r[3 + axis])
            t1 = (c_mn[:, axis][:, None] - ov[None, :]) * iv[None, :]
            t2 = (c_mx[:, axis][:, None] - ov[None, :]) * iv[None, :]
            return torch.minimum(t1, t2), torch.maximum(t1, t2)

        n1x, f1x = slab(0)
        n1y, f1y = slab(1)
        n1z, f1z = slab(2)
        tn = torch.maximum(torch.maximum(n1x, n1y), n1z)
        tf = torch.minimum(torch.minimum(f1x, f1y), f1z)
        del n1x, f1x, n1y, f1y, n1z, f1z
        hit_c = (tn <= tf) & (tf >= eps)  # [C, lanes]
        # max(tn, 0) with +0.0 for tn = -0.0, as jnp.maximum gives it
        entry = torch.where(hit_c, torch.where(tn > 0.0, tn, 0.0), torch.inf)
        hit_parts.append(hit_c.reshape(c_total, nb, BLOCK_N).any(dim=2))
        key_parts.append(entry.reshape(c_total, nb, BLOCK_N).amin(dim=2))
        del tn, tf, hit_c, entry
    hit_b = torch.cat(hit_parts, dim=1)  # [C, NB]
    key_b = torch.where(hit_b, torch.cat(key_parts, dim=1), torch.inf)
    counts = hit_b.sum(dim=0).to(torch.int32)
    order = torch.argsort(key_b, dim=0, stable=True)  # [C, NB], nearest first
    lists = order.T.to(torch.int32).contiguous()
    entries = torch.take_along_dim(key_b, order, dim=0).T.contiguous()
    return counts, lists, entries


def _check(name, x, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}{list(shape)} on {dev}, "
                         f"got {x.dtype}{list(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")


def cull_best_cuda(tiles: torch.Tensor, counts: torch.Tensor, lists: torch.Tensor, entries: torch.Tensor,
                   rays: torch.Tensor, n_valid: int, eps: float,
                   visits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 -> i32[2, Np] (row 0 the quantized key, row 1 the flat
    slot); lanes from ``n_valid`` on hold (INF_BITS, 0).  ``visits``, an
    optional zeroed i32[3, NB], receives the kernel's own work in each
    block: the (warp, cluster) pairs its warps walked, and the triangle and
    sphere tests its lanes ran (``cull_work(..., group=WARP)`` counts the
    same)."""
    global LAUNCHES
    dev = tiles.device
    if dev.type != "cuda":
        raise ValueError(f"cull_best_cuda needs CUDA tensors, got {dev}")
    c_total, rows_per_tile = tiles.shape[0], tiles.shape[1]
    n_pad = rays.shape[1]
    nb = n_pad // BLOCK_N
    if n_pad % BLOCK_N or not 0 <= n_valid <= n_pad:
        raise ValueError(f"rays must cover whole blocks of {BLOCK_N} lanes with n_valid <= {n_pad}")
    if not 2 <= rows_per_tile <= 64 or tiles.shape[2] < ROW_WIDTH or tiles.shape[2] % 4:
        raise ValueError(f"tiles must be f32[C, 1 + L, W] with L <= 63 and W >= {ROW_WIDTH} a multiple of 4, "
                         f"got {list(tiles.shape)}")
    if tiles.data_ptr() % 16:
        raise ValueError("tiles must start on a 16-byte boundary (the kernel copies 16-byte chunks)")
    _check("tiles", tiles, torch.float32, tiles.shape, dev)
    _check("counts", counts, torch.int32, (nb,), dev)
    _check("lists", lists, torch.int32, (nb, c_total), dev)
    _check("entries", entries, torch.float32, (nb, c_total), dev)
    _check("rays", rays, torch.float32, (8, n_pad), dev)
    if visits is not None:
        _check("visits", visits, torch.int32, (3, nb), dev)
    out = torch.empty((2, n_pad), dtype=torch.int32, device=dev)
    if nb == 0:
        return out
    launch = kernels.load(SOURCE, "cull_best_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(tiles.data_ptr(), c_total, rows_per_tile, tiles.shape[2],
                     counts.data_ptr(), lists.data_ptr(), entries.data_ptr(), rays.data_ptr(),
                     n_pad, n_valid, float(np.float32(eps)), out.data_ptr(),
                     None if visits is None else visits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cull_best kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def _walk(tiles: torch.Tensor, counts: torch.Tensor, lists: torch.Tensor, rays: torch.Tensor, eps: float,
          entries: Optional[torch.Tensor] = None, group: Optional[int] = None, n_valid: Optional[int] = None,
          count_work: bool = False):
    """The walk of K2 in plain PyTorch: list positions in order, vectorised
    over the blocks that reach each position and over their lanes, with the
    kernel's FP32 operations in the kernel's order.

    Without ``group`` every lane walks its block's whole list.  With
    ``group`` (a divisor of BLOCK_N) and ``entries``, each run of ``group``
    lanes stops as K2's warps do: before position j it walks on only while
    some real lane of it holds a best key >= entries[j] (bits).  Lanes from
    ``n_valid`` on are padding: they take part in no prune and no vote and
    keep (INF_BITS, 0).  Returns (best_key i32[NB, BN], best_slot i32[NB, BN],
    work), ``work`` None unless ``count_work``: then a dict of the per-lane
    slab tests (every lane of a walking group, for every position the group
    walks), triangle and sphere tests (rows of the clusters whose prune the
    lane passes, less its ignored primitive), the distinct clusters walked,
    each block's furthest position walked, and the (group, cluster) pairs
    in which some lane of the group passed the prune (the group then runs
    the cluster's rows)."""
    eps = float(np.float32(eps))
    nb = counts.shape[0]
    l_prims = tiles.shape[1] - 1
    dev = tiles.device
    lanes = rays.reshape(8, nb, BLOCK_N)
    ox, oy, oz, dx, dy, dz = (lanes[k] for k in range(6))
    ign = lanes[6].view(torch.int32)
    real = torch.arange(nb * BLOCK_N, device=dev).reshape(nb, BLOCK_N) < (nb * BLOCK_N if n_valid is None
                                                                            else n_valid)
    if group is not None:
        if entries is None or group < 1 or BLOCK_N % group:
            raise ValueError(f"a group exit needs the entries and a group dividing {BLOCK_N}, got {group}")
        entry_bits = entries.contiguous().view(torch.int32)
        alive = torch.ones((nb, BLOCK_N // group), dtype=torch.bool, device=dev)

    # per-lane watertight shear (reference src/geometry.cpp:16-45)
    from simple_spectral_torch.render.intersect import _pick_axes

    kx, ky, kz, d_kz = _pick_axes(V3(dx, dy, dz))
    inv_dz = 1.0 / torch.where(d_kz == 0.0, 1.0, d_kz)
    sx = select3(kx, dx, dy, dz) * inv_dz
    sy = select3(ky, dx, dy, dz) * inv_dz
    sz = inv_dz
    ivx, ivy, ivz = _inv_safe(dx), _inv_safe(dy), _inv_safe(dz)

    rows = tiles[:, :, :ROW_WIDTH]
    iota_l = torch.arange(l_prims, dtype=torch.int32, device=dev)[None, :, None]
    best_key = torch.full((nb, BLOCK_N), INF_BITS, dtype=torch.int32, device=dev)
    best_slot = torch.zeros((nb, BLOCK_N), dtype=torch.int32, device=dev)
    work = None
    if count_work:
        work = {"slab": torch.zeros((nb, BLOCK_N), dtype=torch.int64, device=dev),
                "tri": torch.zeros((nb, BLOCK_N), dtype=torch.int64, device=dev),
                "sphere": torch.zeros((nb, BLOCK_N), dtype=torch.int64, device=dev),
                "clusters": torch.zeros(tiles.shape[0], dtype=torch.bool, device=dev),
                "positions": torch.zeros(nb, dtype=torch.int64, device=dev),
                "row_pairs": 0}
    counts = counts.to(torch.int64)
    for j in range(int(counts.max()) if nb else 0):
        reach = counts > j
        if group is not None:
            reach &= alive.any(dim=1)
        blk = torch.nonzero(reach).squeeze(1)
        if blk.numel() == 0:
            break
        c = lists[blk, j].to(torch.int64)
        tile = rows[c]  # [A, 1+L, 12]
        if group is None:
            walking = torch.ones((blk.numel(), BLOCK_N), dtype=torch.bool, device=dev)
        else:
            vote = real[blk] & (best_key[blk] >= entry_bits[blk, j][:, None])
            alive[blk] = alive[blk] & vote.reshape(blk.numel(), -1, group).any(dim=2)
            walking = alive[blk].repeat_interleave(group, dim=1)  # [A, BN]

        def lane(x):  # [A, BN] -> [A, 1, BN], broadcast against the rows
            return x[blk][:, None, :]

        def word(k):  # [A, L, 1]
            return tile[:, 1:, k][:, :, None]

        o_x, o_y, o_z, d_x, d_y, d_z = (lane(x) for x in (ox, oy, oz, dx, dy, dz))

        # per-lane AABB prune against the running best (quantized) distance
        best_dist = best_key[blk].view(torch.float32)[:, None, :]
        box = tile[:, 0, :][:, None, :, None]  # [A, 1, 12, 1]
        t1x = (box[:, :, 2] - o_x) * lane(ivx)
        t2x = (box[:, :, 5] - o_x) * lane(ivx)
        t1y = (box[:, :, 3] - o_y) * lane(ivy)
        t2y = (box[:, :, 6] - o_y) * lane(ivy)
        t1z = (box[:, :, 4] - o_z) * lane(ivz)
        t2z = (box[:, :, 7] - o_z) * lane(ivz)
        tn = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
        tf = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
        live = (tn <= tf) & (tf >= eps) & (tn <= best_dist) & lane(real) & walking[:, None, :]  # [A, 1, BN]

        kind = word(0).view(torch.int32)
        prim = word(11).view(torch.int32)
        k_x, k_y, k_z = lane(kx), lane(ky), lane(kz)
        s_x, s_y = lane(sx), lane(sy)

        def sheared(v0):
            rx = word(2 + 3 * v0) - o_x
            ry = word(3 + 3 * v0) - o_y
            rz = word(4 + 3 * v0) - o_z
            r_kx = select3(k_x, rx, ry, rz)
            r_ky = select3(k_y, rx, ry, rz)
            r_kz = select3(k_z, rx, ry, rz)
            return r_kx - s_x * r_kz, r_ky - s_y * r_kz, r_kz

        ax_a, ay_a, az_a = sheared(0)
        ax_b, ay_b, az_b = sheared(1)
        ax_c, ay_c, az_c = sheared(2)
        u = ay_b * ax_c - ax_b * ay_c
        v = ay_c * ax_a - ax_c * ay_a
        w = ay_a * ax_b - ax_a * ay_b
        inside = ((u >= 0.0) & (v >= 0.0) & (w >= 0.0)) | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0))
        det = u + v + w
        t_scaled = lane(sz) * (u * az_a + v * az_b + w * az_c)
        same_sign = (det < 0.0) == (t_scaled < 0.0)
        tri_dist = t_scaled / torch.where(det == 0.0, 1.0, det)
        tri_ok = inside & (torch.abs(det) > eps) & same_sign & (tri_dist >= eps)

        # spheres: the nearest root >= eps (|d| = 1)
        ocx = o_x - word(2)
        ocy = o_y - word(3)
        ocz = o_z - word(4)
        r2 = word(5) * word(5)
        bq = ocx * d_x + ocy * d_y + ocz * d_z
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        s_near = -bq - sq
        s_far = -bq + sq
        sph_dist = torch.where(s_near >= eps, s_near, s_far)
        sph_ok = (disc > 0.0) & (sph_dist >= eps)

        not_ign = prim != lane(ign)
        is_tri, is_sph = (kind == KIND_TRI) & not_ign, (kind == KIND_SPHERE) & not_ign
        cand = torch.where(is_tri & tri_ok, tri_dist, torch.inf)
        cand = torch.where(is_sph & sph_ok, sph_dist, cand)
        cand = torch.where(live, cand, torch.inf)
        key = (cand.view(torch.int32) & ~63) | iota_l
        tile_key = key.amin(dim=1)  # [A, BN]

        bk = best_key[blk]
        better = tile_key < bk
        new_slot = (c * (1 + l_prims) + 1).to(torch.int32)[:, None] + (tile_key & 63)
        best_slot[blk] = torch.where(better, new_slot, best_slot[blk])
        best_key[blk] = torch.where(better, tile_key & ~63, bk)
        if count_work:
            work["slab"][blk] += walking
            work["tri"][blk] += (is_tri & live).sum(dim=1)
            work["sphere"][blk] += (is_sph & live).sum(dim=1)
            walked = walking.any(dim=1)
            work["clusters"][c[walked]] = True
            work["positions"][blk[walked]] = j + 1
            work["row_pairs"] += int(live.reshape(blk.numel(), -1, group or BLOCK_N).any(dim=2).sum())
    return best_key, best_slot, work


def cull_best_plain(tiles: torch.Tensor, counts: torch.Tensor, lists: torch.Tensor, rays: torch.Tensor,
                    eps: float, entries: Optional[torch.Tensor] = None, group: Optional[int] = None,
                    n_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch twin of K2 -> i32[2, Np] (key, slot).  It tests every
    listed cluster (no early exit, so it needs no entry distances), which
    gives the same result as the kernel's walk; given ``entries`` and
    ``group`` each group of that many lanes stops by the kernel's exit vote
    instead (``group=WARP`` is K2's walk), which changes no key and no slot.
    Lanes from ``n_valid`` on, when it is given, hold (INF_BITS, 0)."""
    best_key, best_slot, _ = _walk(tiles, counts, lists, rays, eps, entries, group, n_valid)
    return torch.stack([best_key.reshape(-1), best_slot.reshape(-1)])


def cull_work(tiles: torch.Tensor, counts: torch.Tensor, lists: torch.Tensor, entries: torch.Tensor,
              rays: torch.Tensor, eps: float, n_valid: Optional[int] = None, group: int = 1) -> dict:
    """The work of an exact walk of these inputs, for K2's bound.

    With ``group=1`` each real lane walks its block's list with its own
    running best and stops at the first position whose entry exceeds it:
    every exact walk of these lists does at least this work, whatever
    kernel does it.  ``group=WARP`` counts K2's own walk (its ``visits``),
    ``group=BLOCK_N`` that of a walk with all lanes of a block in step.
    Returns per-lane i64[Np] ``slab``, ``tri`` and ``sphere`` test counts
    (padding lanes of a group that walks do its slab tests), and totals:
    ``ops`` (SLAB_OPS, OPS_PER_TRIANGLE_TEST and SPHERE_OPS each), and
    ``bytes``: the 12 words of each row of every cluster some lane walks to,
    the rays in (8 words a lane) and key and slot out, the counts, and the
    list and entry words up to each block's furthest position walked; and
    ``row_pairs``, the (group, cluster) pairs whose rows some lane of the
    group tests."""
    _, _, work = _walk(tiles, counts, lists, rays, eps, entries, group, n_valid, count_work=True)
    slab, tri, sph = (work[k].reshape(-1) for k in ("slab", "tri", "sphere"))
    clusters = int(work["clusters"].sum())
    positions = int(work["positions"].sum())
    n_pad = rays.shape[1]
    ops = int(slab.sum()) * SLAB_OPS + int(tri.sum()) * OPS_PER_TRIANGLE_TEST + int(sph.sum()) * SPHERE_OPS
    bytes_moved = (clusters * tiles.shape[1] * 12 * 4 + n_pad * (8 + 2) * 4 + counts.numel() * 4
                   + positions * 2 * 4)
    return {"slab": slab, "tri": tri, "sphere": sph, "ops": ops, "bytes": bytes_moved, "clusters": clusters,
            "positions": positions, "row_pairs": work["row_pairs"]}


def cull_best(tiles: torch.Tensor, counts: torch.Tensor, lists: torch.Tensor, entries: torch.Tensor,
              rays: torch.Tensor, n_valid: int, eps: float) -> torch.Tensor:
    """Stage 3 -> i32[2, Np] (key, slot).  CUDA tensors launch K2, CPU
    tensors run the twin; lanes from ``n_valid`` on are padding."""
    if tiles.device.type == "cpu":
        return cull_best_plain(tiles, counts, lists, rays, eps)
    return cull_best_cuda(tiles, counts, lists, entries, rays, n_valid, eps)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 5 bits of x to every third bit (Morton interleave helper)."""
    x = (x | (x << 8)) & 0x0300F
    x = (x | (x << 4)) & 0x030C3
    x = (x | (x << 2)) & 0x09249
    return x


def morton_order(tiles: torch.Tensor, o: V3, d: V3) -> torch.Tensor:
    """Lane order by (origin Morton cell over the scene's 32^3 grid,
    direction octant), stable: i64[N]."""
    mn = tiles[:, 0, 2:5].amin(dim=0)
    mx = tiles[:, 0, 5:8].amax(dim=0)
    scale = 31.0 / torch.clamp_min(mx - mn, 1e-6)

    def q(c, axis):  # clamping before the cast equals the JAX clip after it
        return torch.clamp((c - mn[axis]) * scale[axis], 0.0, 31.0).to(torch.int32)

    morton = (_part1by2(q(o.x, 0)) << 2) | (_part1by2(q(o.y, 1)) << 1) | _part1by2(q(o.z, 2))
    octant = ((d.x < 0).to(torch.int32) << 2) | ((d.y < 0).to(torch.int32) << 1) | (d.z < 0).to(torch.int32)
    return torch.argsort((morton << 3) | octant, stable=True)


def intersect_rays_cull(scene, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float, need_attrs: bool = True,
                        sort_rays: Optional[bool] = None):
    """Closest hit through the block cull.  Agrees with the dense sweep up
    to the packed key's tie class.  ``sort_rays`` (default: from
    SORT_MIN_CLUSTERS clusters on) runs the lanes in :func:`morton_order`,
    so that incoherent bounce and shadow rays form coherent blocks, and
    returns the records in the callers' order."""
    from simple_spectral_torch.render.bvh import recover_hit_record

    tiles = scene.cull_tiles
    if sort_rays is None:
        sort_rays = tiles.shape[0] >= SORT_MIN_CLUSTERS
    if sort_rays:
        order = morton_order(tiles, o, d)
        rec = intersect_rays_cull(scene, V3(o.x[order], o.y[order], o.z[order]),
                                  V3(d.x[order], d.y[order], d.z[order]), ignore_prim[order], eps,
                                  need_attrs, sort_rays=False)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return type(rec)(*(V3(*(c[inv] for c in f)) if isinstance(f, V3) else f[inv] for f in rec))

    n = o.x.shape[0]
    rays = cull_rays(o, d, ignore_prim)
    counts, lists, entries = cull_lists(tiles, rays, eps)
    out = cull_best(tiles, counts, lists, entries, rays, n, eps)
    best_key, best_slot = out[0, :n], out[1, :n]
    best_dist = torch.where(best_key < INF_BITS, best_key.view(torch.float32), torch.inf)
    return recover_hit_record(scene, tiles.reshape(-1, TILE_W), scene.cull_entry_ref, scene.cull_entry_mat,
                              best_slot, best_dist, o, d, need_attrs, recompute_dist=True)
