"""Host-side SAH builds and the winner-only hit recovery of the scale path
(PyTorch port of ``simple_spectral_tpu.render.bvh``, host half).

* :func:`_split_sah` and :func:`build_bvh_arrays` are the JAX package's
  numpy builds, copied: a binned-SAH binary BVH over triangles and spheres,
  flattened into one skip-link entry array in DFS preorder.  Each entry is a
  packed 48-byte row (f32[12], ints bitcast): word 0 the kind, word 1 the
  skip link, words 2..10 the payload (an AABB, three vertices, or a centre
  and radius), word 11 the primitive id.  ``render/cull.py`` cuts the same
  SAH splits into cluster tiles with the same row layout.
* :func:`intersect_rays_bvh`, the BVH arm (``intersect_impl="bvh"``): every
  lane walks the skip-link array in lockstep (:func:`bvh_walk`), a plain
  torch loop as the JAX package's ``lax.while_loop``, and the winner's
  attributes come from :func:`recover_hit_record` with the walk's exact
  distance.
* :func:`recover_hit_record` turns a per-lane winning row into a
  ``HitRecord``, exactly as the JAX package does for its BVH and block-cull
  arms.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from simple_spectral_torch.render.vec import V3, select3

# Entry kinds (word 0 of each packed row).
KIND_INTERNAL = 0
KIND_TRI = 1
KIND_SPHERE = 2

ROW_WIDTH = 12  # f32 words per entry (48 bytes)

_INF = np.float32(np.inf)


def _aabb_area(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    e = np.maximum(mx - mn, 0.0)
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0])


def _split_sah(idxs, cent, mn, mx, n_bins: int = 16):
    """Binned-SAH split of a primitive subset; both halves are non-empty.
    Returns (left_idxs, right_idxs)."""
    c = cent[idxs]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    axis = int(np.argmax(cmax - cmin))
    extent = float(cmax[axis] - cmin[axis])
    if extent < 1e-12:
        half = len(idxs) // 2  # all centroids coincide: arbitrary halves
        return idxs[:half], idxs[half:]
    scale = n_bins / extent
    b = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int64), n_bins - 1)
    counts = np.bincount(b, minlength=n_bins)
    bmn = np.full((n_bins, 3), _INF, np.float64)
    bmx = np.full((n_bins, 3), -_INF, np.float64)
    np.minimum.at(bmn, b, mn[idxs])
    np.maximum.at(bmx, b, mx[idxs])
    # prefix (left) and suffix (right) unions over the bin boundaries
    lmn = np.minimum.accumulate(bmn, axis=0)
    lmx = np.maximum.accumulate(bmx, axis=0)
    rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1]
    rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1]
    nl = np.cumsum(counts)[:-1]  # split after bin i: bins 0..i go left
    nr = len(idxs) - nl
    cost = nl * _aabb_area(lmn[:-1], lmx[:-1]) + nr * _aabb_area(rmn[1:], rmx[1:])
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        half = len(idxs) // 2
        order = np.argsort(c[:, axis], kind="stable")
        return idxs[order[:half]], idxs[order[half:]]
    sel = b <= best
    return idxs[sel], idxs[~sel]


def primitive_bounds(tri_verts, tri_prim, tri_mat, sphere_center, sphere_radius, sphere_prim, sphere_mat):
    """Per-primitive float64 bounds, centroids, ids and materials over the
    triangles followed by the spheres: (t, mn, mx, cent, prim_id, mat_id)."""
    tri_verts = np.asarray(tri_verts, np.float64)
    t = tri_verts.shape[0]
    sp = 0 if sphere_center is None else int(np.shape(sphere_center)[0])
    p = t + sp
    mn = np.empty((p, 3), np.float64)
    mx = np.empty((p, 3), np.float64)
    mn[:t] = tri_verts.min(axis=1)
    mx[:t] = tri_verts.max(axis=1)
    if sp:
        sc = np.asarray(sphere_center, np.float64)
        sr = np.asarray(sphere_radius, np.float64)[:, None]
        mn[t:] = sc - sr
        mx[t:] = sc + sr
    cent = 0.5 * (mn + mx)
    prim_id = np.concatenate([np.asarray(tri_prim, np.int64)] + ([np.asarray(sphere_prim, np.int64)] if sp else []))
    mat_id = np.concatenate([np.asarray(tri_mat, np.int64)] + ([np.asarray(sphere_mat, np.int64)] if sp else []))
    return t, mn, mx, cent, prim_id, mat_id


def build_bvh_arrays(
    tri_verts: np.ndarray,  # f[T, 3, 3]
    tri_prim: np.ndarray,  # i[T]
    tri_mat: np.ndarray,  # i[T]
    sphere_center: Optional[np.ndarray] = None,  # f[Sp, 3]
    sphere_radius: Optional[np.ndarray] = None,  # f[Sp]
    sphere_prim: Optional[np.ndarray] = None,  # i[Sp]
    sphere_mat: Optional[np.ndarray] = None,  # i[Sp]
    leaf_size: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The flattened skip-link BVH, built on the host.

    Returns (nodes f32[Nn, 12], entry_ref i32[Nn], entry_mat i32[Nn]);
    entry_ref holds the triangle index (triangle entries), the sphere index
    (sphere entries) or -1 (internal entries)."""
    tri_verts = np.asarray(tri_verts, np.float64)
    t, mn, mx, cent, prim_id, mat_id = primitive_bounds(
        tri_verts, tri_prim, tri_mat, sphere_center, sphere_radius, sphere_prim, sphere_mat)
    p = mn.shape[0]
    sp = p - t
    assert p > 0, "empty scene"

    # DFS with an explicit stack ("node" to expand, "patch" to backfill the
    # internal entry's skip link once its subtree is emitted)
    kinds: list = []
    skips: list = []
    refs: list = []
    internal_pos: list = []
    internal_mn: list = []
    internal_mx: list = []
    prim_pos: list = []
    prim_idx: list = []

    stack = [("node", np.arange(p, dtype=np.int64))]
    while stack:
        tag, x = stack.pop()
        if tag == "patch":
            skips[x] = len(kinds)
            continue
        idxs = x
        if len(idxs) <= leaf_size:
            for gi in idxs:
                pos = len(kinds)
                kinds.append(KIND_TRI if gi < t else KIND_SPHERE)
                skips.append(pos + 1)
                refs.append(int(gi) if gi < t else int(gi - t))
                prim_pos.append(pos)
                prim_idx.append(int(gi))
            continue
        pos = len(kinds)
        kinds.append(KIND_INTERNAL)
        skips.append(-1)  # patched below
        refs.append(-1)
        internal_pos.append(pos)
        internal_mn.append(mn[idxs].min(axis=0))
        internal_mx.append(mx[idxs].max(axis=0))
        left, right = _split_sah(idxs, cent, mn, mx)
        stack.append(("patch", pos))
        stack.append(("node", right))
        stack.append(("node", left))

    nn = len(kinds)
    rows = np.zeros((nn, ROW_WIDTH), np.float32)
    rows_i = rows.view(np.int32)
    rows_i[:, 0] = np.asarray(kinds, np.int32)
    rows_i[:, 1] = np.asarray(skips, np.int32)
    if internal_pos:
        ip = np.asarray(internal_pos, np.int64)
        rows[ip, 2:5] = np.asarray(internal_mn, np.float32)
        rows[ip, 5:8] = np.asarray(internal_mx, np.float32)
    pp = np.asarray(prim_pos, np.int64)
    pi = np.asarray(prim_idx, np.int64)
    tri_sel = pi < t
    tp, ti = pp[tri_sel], pi[tri_sel]
    rows[tp, 2:11] = tri_verts[ti].reshape(-1, 9).astype(np.float32)
    if sp:
        spp_, si = pp[~tri_sel], pi[~tri_sel] - t
        rows[spp_, 2:5] = np.asarray(sphere_center, np.float32)[si]
        rows[spp_, 5] = np.asarray(sphere_radius, np.float32)[si]
    rows_i[pp, 11] = prim_id[pi].astype(np.int32)

    entry_ref = np.asarray(refs, np.int32)
    entry_mat = np.zeros(nn, np.int32)
    entry_mat[pp] = mat_id[pi].astype(np.int32)
    return rows, entry_ref, entry_mat


def _shear(d: V3):
    """Per-lane watertight constants (reference src/geometry.cpp:16-42):
    the axis permutation kx, ky, kz and the shear sx, sy, sz."""
    from simple_spectral_torch.render.intersect import _pick_axes

    kx, ky, kz, dz = _pick_axes(d)
    inv_dz = 1.0 / torch.where(dz == 0.0, 1.0, dz)
    return kx, ky, kz, select3(kx, d.x, d.y, d.z) * inv_dz, select3(ky, d.x, d.y, d.z) * inv_dz, inv_dz


def _sheared_row(rows: torch.Tensor, v0: int, o: V3, kx, ky, kz, sx, sy):
    """Vertex ``v0`` of each lane's triangle row relative to the ray origin,
    permuted and sheared: (x, y, z) of the watertight test."""
    rx = rows[:, 2 + 3 * v0] - o.x
    ry = rows[:, 3 + 3 * v0] - o.y
    rz = rows[:, 4 + 3 * v0] - o.z
    r_kx = select3(kx, rx, ry, rz)
    r_ky = select3(ky, rx, ry, rz)
    r_kz = select3(kz, rx, ry, rz)
    return r_kx - sx * r_kz, r_ky - sy * r_kz, r_kz


def bvh_walk(scene, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float):
    """The stackless skip-link walk of the JAX package's
    ``intersect_rays_bvh`` (render/bvh.py:220-351), step for step.

    Per lane the state is (ptr, best distance, best entry).  Each step
    gathers one row per lane: an internal entry whose AABB is hit within
    [eps, best] descends to ``ptr + 1``, otherwise jumps its subtree by the
    skip link; a triangle or sphere entry updates the best hit and moves on.
    The loop runs while any lane has ``ptr < nn``, the same body for every
    lane, so a lane past the end re-tests entry ``nn - 1`` (``idx = min(ptr,
    nn - 1)``) while the others still walk, as in the JAX loop.  Each step
    reads that condition back to the host.  Directions must be unit length
    (the sphere test relies on |d| = 1).

    Returns (best_entry i32[N], best_dist f32[N], steps)."""
    from simple_spectral_torch.render.intersect import INF

    nodes = scene.bvh_nodes
    nn = scene.n_bvh_entries
    n = o.x.shape[0]
    dev = o.x.device
    shear = _shear(d)  # shared by every triangle test
    sz = shear[5]

    # slab-test inverse directions; exact zeros become a tiny value, so that
    # t1/t2 are huge but finite with the right containment semantics
    def _inv(c):
        return 1.0 / torch.where(torch.abs(c) < 1e-30, 1e-30, c)

    ivx, ivy, ivz = _inv(d.x), _inv(d.y), _inv(d.z)

    ptr = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_dist = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_entry = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = 0
    while bool((ptr < nn).any()):
        steps += 1
        idx = torch.clamp_max(ptr, nn - 1)
        rows = nodes[idx.to(torch.int64)]  # f32[N, 12], one gather per step
        kind = rows[:, 0].view(torch.int32)
        skip = rows[:, 1].view(torch.int32)
        prim = rows[:, 11].view(torch.int32)

        # internal: AABB slab test pruned by the current best
        t1x = (rows[:, 2] - o.x) * ivx
        t2x = (rows[:, 5] - o.x) * ivx
        t1y = (rows[:, 3] - o.y) * ivy
        t2y = (rows[:, 6] - o.y) * ivy
        t1z = (rows[:, 4] - o.z) * ivz
        t2z = (rows[:, 7] - o.z) * ivz
        tn = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
        tf = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
        aabb_hit = (tn <= tf) & (tf >= eps) & (tn <= best_dist)

        # triangle: watertight test on the inlined 9 vertex floats
        ax_a, ay_a, az_a = _sheared_row(rows, 0, o, *shear[:5])
        ax_b, ay_b, az_b = _sheared_row(rows, 1, o, *shear[:5])
        ax_c, ay_c, az_c = _sheared_row(rows, 2, o, *shear[:5])
        u = ay_b * ax_c - ax_b * ay_c
        v = ay_c * ax_a - ax_c * ay_a
        w = ay_a * ax_b - ax_a * ay_b
        inside = ((u >= 0.0) & (v >= 0.0) & (w >= 0.0)) | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0))
        det = u + v + w
        ok_det = torch.abs(det) > eps
        t_scaled = sz * (u * az_a + v * az_b + w * az_c)
        same_sign = torch.signbit(det) == torch.signbit(t_scaled)
        tri_dist = t_scaled / torch.where(det == 0.0, 1.0, det)
        tri_ok = inside & ok_det & same_sign & (tri_dist >= eps)

        # sphere: nearest quadratic root >= eps (|d| = 1)
        ocx = o.x - rows[:, 2]
        ocy = o.y - rows[:, 3]
        ocz = o.z - rows[:, 4]
        r2 = rows[:, 5] * rows[:, 5]
        bq = ocx * d.x + ocy * d.y + ocz * d.z
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        sph_near = -bq - sq
        sph_far = -bq + sq
        sph_dist = torch.where(sph_near >= eps, sph_near, sph_far)
        sph_ok = (disc > 0.0) & (sph_dist >= eps)

        not_ign = prim != ignore_prim
        cand = torch.where((kind == KIND_TRI) & tri_ok & not_ign, tri_dist, INF)
        cand = torch.where((kind == KIND_SPHERE) & sph_ok & not_ign, sph_dist, cand)
        better = cand < best_dist
        best_dist = torch.where(better, cand, best_dist)
        best_entry = torch.where(better, idx, best_entry)

        nxt = torch.where((kind == KIND_INTERNAL) & aabb_hit, ptr + 1, skip)
        ptr = torch.where(ptr < nn, nxt, ptr)
    return best_entry, best_dist, steps


def intersect_rays_bvh(scene, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float, need_attrs: bool = True):
    """Closest hit through the BVH walk (:func:`bvh_walk`), then the
    winner's attributes.  The walk's distance is exact and is kept (no
    recompute), so the arm agrees with the exact dense route bit for bit up
    to closest-hit ties between exactly equal distances (DFS order here,
    the lower triangle index there)."""
    best_entry, best_dist, _ = bvh_walk(scene, o, d, ignore_prim, eps)
    return recover_hit_record(scene, scene.bvh_nodes, scene.bvh_entry_ref, scene.bvh_entry_mat,
                              best_entry, best_dist, o, d, need_attrs)


def recover_hit_record(scene, rows_table: torch.Tensor, entry_ref: torch.Tensor, entry_mat: torch.Tensor,
                       best_entry: torch.Tensor, best_dist: torch.Tensor, o: V3, d: V3, need_attrs: bool,
                       recompute_dist: bool = False):
    """Winner-only attribute recovery (the JAX package's
    ``recover_hit_record``, render/bvh.py:349-473).

    ``rows_table`` is a packed entry array in the row layout above (any
    width of at least 12 words); ``best_entry`` indexes it per lane, and a
    lane missed where ``best_dist`` is inf.  ``recompute_dist`` replaces the
    distance with the exact one: the triangle's from its scaled
    barycentrics, the sphere's as the root of the quadratic NEAREST the
    given (quantized) distance -- not the "near root if >= eps" rule of the
    intersection test, a quirk of the JAX package kept for lane parity."""
    from simple_spectral_torch.render.intersect import INF, HitRecord

    hit = torch.isfinite(best_dist)
    entry = torch.where(hit, best_entry, 0).to(torch.int64)
    rows = rows_table[entry, :ROW_WIDTH]  # f32[N, 12]
    kind = rows[:, 0].view(torch.int32)
    ref = entry_ref[entry]
    mat = torch.where(hit, entry_mat[entry], 0).to(torch.int32)
    prim = torch.where(hit, rows[:, 11].view(torch.int32), -1).to(torch.int32)
    is_tri = hit & (kind == KIND_TRI)
    tri = torch.where(is_tri, ref, 0).to(torch.int32)
    if not need_attrs:
        zero = torch.zeros_like(best_dist)
        return HitRecord(hit=hit, dist=best_dist, tri=tri, prim=prim, mat=mat,
                         normal=V3(zero, zero, zero), st_s=zero, st_t=zero)

    shear = _shear(d)
    sz = shear[5]
    tri_i = tri.to(torch.int64)
    tn = scene.tri_normal[tri_i]
    tnorm = V3(tn[:, 0], tn[:, 1], tn[:, 2])
    ax_a, ay_a, az_a = _sheared_row(rows, 0, o, *shear[:5])
    ax_b, ay_b, az_b = _sheared_row(rows, 1, o, *shear[:5])
    ax_c, ay_c, az_c = _sheared_row(rows, 2, o, *shear[:5])
    u = ay_b * ax_c - ax_b * ay_c
    v = ay_c * ax_a - ax_c * ay_a
    w = ay_a * ax_b - ax_a * ay_b
    det = u + v + w
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    st = scene.tri_st[tri_i]  # f32[N, 3, 2]
    tri_st_s = (u * st[:, 0, 0] + v * st[:, 1, 0] + w * st[:, 2, 0]) * inv_det
    tri_st_t = (u * st[:, 0, 1] + v * st[:, 1, 1] + w * st[:, 2, 1]) * inv_det
    if recompute_dist:
        t_scaled = sz * (u * az_a + v * az_b + w * az_c)
        tri_dist = torch.where(is_tri & (det != 0.0), t_scaled / torch.where(det != 0.0, det, 1.0), best_dist)
        best_dist = torch.where(is_tri, tri_dist, best_dist)
        if scene.n_spheres:
            is_sph_r = hit & (kind == KIND_SPHERE)
            ocx = o.x - rows[:, 2]
            ocy = o.y - rows[:, 3]
            ocz = o.z - rows[:, 4]
            bq = ocx * d.x + ocy * d.y + ocz * d.z
            cq = ocx * ocx + ocy * ocy + ocz * ocz - rows[:, 5] * rows[:, 5]
            disc = bq * bq - cq
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            near, far = -bq - sq, -bq + sq
            pick_near = torch.abs(near - best_dist) <= torch.abs(far - best_dist)
            sph_dist = torch.where(pick_near, near, far)
            best_dist = torch.where(is_sph_r & (disc > 0.0), sph_dist, best_dist)

    if scene.n_spheres:
        is_sph = hit & (kind == KIND_SPHERE)
        safe_dist = torch.where(hit, best_dist, 0.0)
        hx = o.x + safe_dist * d.x
        hy = o.y + safe_dist * d.y
        hz = o.z + safe_dist * d.z
        inv_r = 1.0 / torch.clamp_min(rows[:, 5], 1e-30)
        snx = (hx - rows[:, 2]) * inv_r
        sny = (hy - rows[:, 3]) * inv_r
        snz = (hz - rows[:, 4]) * inv_r
        # equirectangular sphere ST (an extension: the reference has no spheres)
        sph_s = 0.5 + torch.atan2(snz, snx) / (2.0 * math.pi)
        sph_t = 0.5 - torch.asin(torch.clamp(sny, -1.0, 1.0)) / math.pi
        normal = V3(torch.where(is_sph, snx, tnorm.x), torch.where(is_sph, sny, tnorm.y),
                    torch.where(is_sph, snz, tnorm.z))
        st_s = torch.where(is_sph, sph_s, tri_st_s)
        st_t = torch.where(is_sph, sph_t, tri_st_t)
    else:
        normal, st_s, st_t = tnorm, tri_st_s, tri_st_t

    return HitRecord(hit=hit, dist=torch.where(hit, best_dist, INF), tri=tri, prim=prim, mat=mat,
                     normal=normal, st_s=st_s, st_t=st_t)
