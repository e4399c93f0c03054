"""The port's scale path against the JAX package, on the CPU: the host
builds, the stress scene's leaves, the twin of kernel K2 and the block-cull
closest hit, on cornell-stress at the size of tests/test_cull.py (40 boxes,
20 spheres, two sphere lights: 12 clusters of at most 63 primitives).

Oracles: ``build_cluster_arrays`` / ``build_bvh_arrays`` and ``build_scene``
(exact), ``_cull_best(..., interpret=True)`` (the Pallas kernel, on the
twin's own inputs) and ``intersect_rays_cull(..., interpret=True)``.  XLA on
the CPU contracts ``a*b + c`` into fused multiply-adds where the twin rounds
each operation, so a distance may differ in its last bits: the quantized
key then falls one 64-ulp step apart (1 lane in 60 to 120 at these seeds),
and on an ill-conditioned triangle (a small determinant) a few steps; a ray
that grazes an edge may pick another primitive.  EDGE_FLIPS bounds, per
comparison, the lanes with another winner and the lanes whose key or
key distance is more than one step apart; over four seeds no slot and no
primitive differed and at most two lanes per set moved by more than a
step.  All comparisons run at one lane count, so JAX compiles the Pallas
kernel once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import convert
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import bvh as t_bvh
from simple_spectral_torch.render import cull as t_cull
from simple_spectral_torch.render import intersect as t_isect
from simple_spectral_torch.render.vec import V3 as TV3
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import bvh as j_bvh
from simple_spectral_tpu.render import cull as j_cull
from simple_spectral_tpu.render.vec import V3
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

EPS = 1e-3
N = 1500  # two blocks, the second one padded
EDGE_FLIPS = 2
STRESS = dict(scene="cornell-stress", width=8, height=8, spp=1, max_depth=3, stress_boxes=40, stress_spheres=20,
              stress_materials=16, stress_sphere_lights=2, intersect_impl="cull")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on one
    host, and these tensors are large enough for torch to fan out over
    threads that the workers then fight for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(mode):
    cfg, tcfg = RenderConfig(mode=mode, **STRESS), TorchConfig(mode=mode, **STRESS)
    return build_scene(cfg, build_color_tables(cfg)), t_build_scene(tcfg, t_build_tables(tcfg, device="cpu"),
                                                                    device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return _build("rgb")


def _bits(a):
    """Arrays compared bit for bit (the tiles' int words read as f32 are NaNs)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


@pytest.mark.parametrize("mode", ["rgb", "mallett"])
def test_stress_scene_leaves_exact(scenes, mode):
    j_scene, t_scene = scenes if mode == "rgb" else _build(mode)
    assert t_scene.n_spheres == 22 and t_scene.n_sphere_lights == 2 and t_scene.cull_tiles.shape[1:] == (64, 128)
    for f in dataclasses.fields(t_scene):
        got, want = getattr(t_scene, f.name), getattr(j_scene, f.name)
        if dataclasses.is_dataclass(got):
            pairs = [(f"{f.name}.{g.name}", getattr(got, g.name), getattr(want, g.name))
                     for g in dataclasses.fields(got)]
        else:
            pairs = [(f.name, got, want)]
        for name, a, b in pairs:
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
            else:
                assert a == b, name


def test_convert_carries_the_scale_path_leaves(scenes):
    j_scene, t_scene = scenes

    def leaves(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                out[f.name] = leaves(v)
            elif v is None or isinstance(v, (int, float, str, tuple)):
                out[f.name] = v
            else:
                out[f.name] = np.asarray(v)
        return out

    got = convert.scene_from_numpy(leaves(j_scene), device="cpu")
    for name in ("sphere_center", "sphere_radius", "sphere_prim", "sphere_mat", "light_kind", "light_sph",
                 "bvh_nodes", "bvh_entry_ref", "bvh_entry_mat", "cull_tiles", "cull_entry_ref", "cull_entry_mat"):
        np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(t_scene, name)), err_msg=name)
    assert (got.n_spheres, got.n_sphere_lights, got.n_bvh_entries) == (22, 2, t_scene.n_bvh_entries)


def test_host_builds_exact():
    rng = np.random.default_rng(3)
    tv = rng.uniform(0.0, 100.0, size=(300, 3, 3))
    sc = rng.uniform(0.0, 100.0, size=(40, 3))
    args = (tv, np.arange(300) // 2, rng.integers(0, 5, 300), sc, rng.uniform(1.0, 5.0, 40),
            np.arange(150, 190), rng.integers(0, 5, 40))
    for got, want in zip(t_bvh.build_bvh_arrays(*args, leaf_size=4), j_bvh.build_bvh_arrays(*args, leaf_size=4)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    for size in (7, 63):
        for got, want in zip(t_cull.build_cluster_arrays(*args, cluster_size=size),
                             j_cull.build_cluster_arrays(*args, cluster_size=size)):
            np.testing.assert_array_equal(_bits(got), _bits(want))


def _rays(j_scene, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((20, 20, 20), (530, 530, 530), (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ign = rng.integers(-1, j_scene.n_prims, size=N).astype(np.int32)
    return o, d, ign


def _tv3(a):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv3(a):
    return V3(*(jnp.asarray(a[:, i]) for i in range(3)))


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_twin_matches_pallas_cull_best(scenes, sort):
    j_scene, t_scene = scenes
    o, d, ign = _rays(j_scene, seed=11)
    o_t, d_t, ign_t = _tv3(o), _tv3(d), torch.from_numpy(ign)
    if sort:
        order = t_cull.morton_order(t_scene.cull_tiles, o_t, d_t)
        o_t, d_t, ign_t = TV3(*(c[order] for c in o_t)), TV3(*(c[order] for c in d_t)), ign_t[order]
    rays = t_cull.cull_rays(o_t, d_t, ign_t)
    counts, lists, entries = t_cull.cull_lists(t_scene.cull_tiles, rays, EPS)
    got = t_cull.cull_best(t_scene.cull_tiles, counts, lists, entries, rays, N, EPS).numpy()
    want = np.asarray(j_cull._cull_best(
        j_scene.cull_tiles, jnp.asarray(counts.numpy())[:, None], jnp.asarray(lists.numpy()),
        jnp.asarray(entries.numpy()), jnp.asarray(rays.numpy()), 63, EPS, interpret=True))
    hits = got[0, :N] < t_cull.INF_BITS
    assert hits.sum() > N // 2
    np.testing.assert_array_equal(hits, want[0, :N] < t_cull.INF_BITS)
    assert (got[1] != want[1]).sum() <= EDGE_FLIPS
    step = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))[got[1] == want[1]]
    assert (step > 64).sum() <= EDGE_FLIPS
    assert (step == 64).mean() < 0.05


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("need_attrs", [True, False], ids=["attrs", "no-attrs"])
def test_intersect_rays_cull_matches_jax(scenes, sort, need_attrs):
    j_scene, t_scene = scenes
    o, d, ign = _rays(j_scene, seed=5)
    ref = j_cull.intersect_rays_cull(j_scene, _jv3(o), _jv3(d), jnp.asarray(ign), EPS, need_attrs=need_attrs,
                                     interpret=True, sort_rays=sort)
    got = t_cull.intersect_rays_cull(t_scene, _tv3(o), _tv3(d), torch.from_numpy(ign), EPS,
                                     need_attrs=need_attrs, sort_rays=sort)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    same = got.prim.numpy() == np.asarray(ref.prim)
    assert (~same).sum() <= EDGE_FLIPS
    np.testing.assert_array_equal(got.mat.numpy()[same], np.asarray(ref.mat)[same])
    np.testing.assert_array_equal(got.tri.numpy()[same], np.asarray(ref.tri)[same])
    m = hit & same
    if need_attrs:
        # exact distances, recomputed from the winner op by op on both sides
        np.testing.assert_allclose(got.dist.numpy()[m], np.asarray(ref.dist)[m], rtol=1e-5)
        for a, b in ((got.normal.x, ref.normal.x), (got.normal.y, ref.normal.y), (got.normal.z, ref.normal.z),
                     (got.st_s, ref.st_s), (got.st_t, ref.st_t)):
            np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-5, atol=1e-6)
    else:
        # the key's distance: one 2^-17 step apart, a few steps on EDGE_FLIPS lanes
        rel = np.abs(got.dist.numpy()[m] / np.asarray(ref.dist)[m] - 1.0)
        assert (rel > 2.0 ** -16).sum() <= EDGE_FLIPS
    assert not np.any(got.prim.numpy()[hit] == ign[hit])


def test_auto_routes_by_primitive_count(scenes, monkeypatch):
    _, t_scene = scenes
    assert t_isect.resolve_intersect_impl("auto", t_scene) == "xla"
    assert t_isect.resolve_intersect_impl("cull", t_scene) == "cull"
    monkeypatch.setattr(t_isect, "CULL_AUTO_THRESHOLD", t_scene.n_tris + t_scene.n_spheres)
    assert t_isect.resolve_intersect_impl("auto", t_scene) == "cull"
    no_tiles = dataclasses.replace(t_scene, cull_tiles=None)
    assert t_isect.resolve_intersect_impl("auto", no_tiles) == "xla"
    with pytest.raises(ValueError, match="no cluster tiles"):
        t_isect.intersect_rays_dispatch(no_tiles, _tv3(np.zeros((1, 3), np.float32)),
                                        _tv3(np.ones((1, 3), np.float32)), torch.full((1,), -1), EPS, impl="cull")


def test_cuda_wrapper_refuses_cpu_tensors(scenes):
    _, t_scene = scenes
    rays = torch.zeros((8, t_cull.BLOCK_N))
    counts = torch.zeros(1, dtype=torch.int32)
    lists = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        t_cull.cull_best_cuda(t_scene.cull_tiles, counts, lists, torch.zeros((1, 12)), rays, 1, EPS)


def _near_rays(t_scene, j_scene, seed, far=0.02):
    """N seeded rays that start 1 to 10 units in front of a random
    triangle's centroid and point at it, but for a share ``far`` of random
    rays from anywhere in the box: short best distances, so that the exit
    vote fires, and a few long ones that hold their groups back."""
    rng = np.random.default_rng(seed)
    tv = t_scene.tri_verts.numpy()
    cen = tv[rng.integers(0, tv.shape[0], N)].mean(axis=1)
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = cen - rng.uniform(1.0, 10.0, (N, 1)) * d
    pick = rng.random(N) < far
    o[pick] = rng.uniform((20, 20, 20), (530, 530, 530), (N, 3))[pick]
    ign = rng.integers(-1, j_scene.n_prims, size=N).astype(np.int32)
    return o.astype(np.float32), d.astype(np.float32), ign


def _stage2(t_scene, j_scene, sort, seed=11):
    """Stage-2 inputs of the twin for N seeded rays (:func:`_near_rays`),
    optionally in Morton order."""
    o, d, ign = _near_rays(t_scene, j_scene, seed)
    o_t, d_t, ign_t = _tv3(o), _tv3(d), torch.from_numpy(ign)
    if sort:
        order = t_cull.morton_order(t_scene.cull_tiles, o_t, d_t)
        o_t, d_t, ign_t = TV3(*(c[order] for c in o_t)), TV3(*(c[order] for c in d_t)), ign_t[order]
    rays = t_cull.cull_rays(o_t, d_t, ign_t)
    counts, lists, entries = t_cull.cull_lists(t_scene.cull_tiles, rays, EPS)
    return counts, lists, entries, rays


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("group", [32, 128, 1024])
def test_group_exit_walk_equals_the_full_walk(scenes, sort, group):
    """The kernel's walk, each group of lanes stopping by its own exit vote,
    gives every lane the key and slot of the walk over the whole list; on
    sorted rays the vote of a group smaller than a block cuts the walk of
    the real lanes."""
    _, t_scene = scenes
    tiles = t_scene.cull_tiles
    counts, lists, entries, rays = _stage2(t_scene, scenes[0], sort)
    full = t_cull.cull_best_plain(tiles, counts, lists, rays, EPS)
    got = t_cull.cull_best_plain(tiles, counts, lists, rays, EPS, entries=entries, group=group, n_valid=N)
    assert int((full[0, :N] < t_cull.INF_BITS).sum()) > N // 2
    assert torch.equal(got[:, :N], full[:, :N])
    assert bool((got[0, N:] == t_cull.INF_BITS).all()) and bool((got[1, N:] == 0).all())
    walked = t_cull.cull_work(tiles, counts, lists, entries, rays, EPS, n_valid=N, group=group)["slab"][:N]
    listed = counts.to(torch.int64).repeat_interleave(t_cull.BLOCK_N)[:N]
    assert bool((walked <= listed).all())
    if sort and group < t_cull.BLOCK_N:
        assert int(walked.sum()) < int(listed.sum())


def _brute_work(tiles, counts, lists, entries, rays, lanes):
    """(slab, triangle, sphere) tests of each lane in ``lanes``, walking its
    block's list one cluster at a time in numpy float32 with its own running
    best, stopping at the first entry above it."""
    f = np.float32
    eps = f(EPS)
    t = tiles.numpy()
    ti = t.view(np.int32)
    r = rays.numpy()
    ent = entries.numpy().view(np.int32)
    counts, lists = counts.numpy(), lists.numpy()
    inf_key = t_cull.INF_BITS
    out = []
    for i in lanes:
        b = i // t_cull.BLOCK_N
        o, d = r[0:3, i], r[3:6, i]
        ign = r[6:7, i].view(np.int32)[0]
        ad = np.abs(d)
        kz = 0 if (ad[0] > ad[1] and ad[0] > ad[2]) else (1 if ad[1] > ad[2] else 2)
        kx = 0 if kz == 2 else kz + 1
        ky = 0 if kx == 2 else kx + 1
        if d[kz] < 0:
            kx, ky = ky, kx
        inv_dz = f(1.0) / (d[kz] if d[kz] != 0 else f(1.0))
        sx, sy, sz = d[kx] * inv_dz, d[ky] * inv_dz, inv_dz
        iv = f(1.0) / np.where(np.abs(d) < f(1e-30), f(1e-30), d)
        best_key, slab, tri, sph = inf_key, 0, 0, 0
        for j in range(counts[b]):
            if ent[b, j] > best_key:
                break
            slab += 1
            c = lists[b, j]
            t1, t2 = (t[c, 0, 2:5] - o) * iv, (t[c, 0, 5:8] - o) * iv
            tn, tf = np.minimum(t1, t2).max(), np.maximum(t1, t2).min()
            if not (tn <= tf and tf >= eps and tn <= np.int32(best_key).view(np.float32)):
                continue
            rows, kind, prim = t[c, 1:], ti[c, 1:, 0], ti[c, 1:, 11]
            is_tri = (kind == t_bvh.KIND_TRI) & (prim != ign)
            is_sph = (kind == t_bvh.KIND_SPHERE) & (prim != ign)
            tri += int(is_tri.sum())
            sph += int(is_sph.sum())
            a = [(rows[:, 2 + 3 * v:5 + 3 * v] - o) for v in range(3)]
            ax = [r_[:, kx] - sx * r_[:, kz] for r_ in a]
            ay = [r_[:, ky] - sy * r_[:, kz] for r_ in a]
            az = [r_[:, kz] for r_ in a]
            u = ay[1] * ax[2] - ax[1] * ay[2]
            v = ay[2] * ax[0] - ax[2] * ay[0]
            w = ay[0] * ax[1] - ax[0] * ay[1]
            inside = ((u >= 0) & (v >= 0) & (w >= 0)) | ((u <= 0) & (v <= 0) & (w <= 0))
            det = u + v + w
            t_scaled = sz * (u * az[0] + v * az[1] + w * az[2])
            tri_dist = t_scaled / np.where(det == 0, f(1.0), det)
            tri_ok = inside & (np.abs(det) > eps) & ((det < 0) == (t_scaled < 0)) & (tri_dist >= eps)
            oc = [o[k] - rows[:, 2 + k] for k in range(3)]
            bq = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
            cq = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - rows[:, 5] * rows[:, 5]
            disc = bq * bq - cq
            sq = np.sqrt(np.maximum(disc, f(0.0)))
            s_near, s_far = -bq - sq, -bq + sq
            sph_dist = np.where(s_near >= eps, s_near, s_far)
            sph_ok = (disc > 0) & (sph_dist >= eps)
            cand = np.where(is_tri & tri_ok, tri_dist, f(np.inf))
            cand = np.where(is_sph & sph_ok, sph_dist, cand).astype(np.float32)
            key = int(((cand.view(np.int32) & ~63) | np.arange(rows.shape[0], dtype=np.int32)).min())
            if key < best_key:
                best_key = key & ~63
        out.append((slab, tri, sph))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_cull_work_equals_a_brute_force_count(scenes, sort):
    """cull_work's per-lane counts against a lane-by-lane numpy walk, on 300
    lanes of both blocks, and nothing for the padding lanes."""
    _, t_scene = scenes
    tiles = t_scene.cull_tiles
    counts, lists, entries, rays = _stage2(t_scene, scenes[0], sort, seed=17)
    work = t_cull.cull_work(tiles, counts, lists, entries, rays, EPS, n_valid=N)
    lanes = np.random.default_rng(5).choice(N, size=300, replace=False)
    want = _brute_work(tiles, counts, lists, entries, rays, lanes)
    got = np.stack([work[k].numpy()[lanes] for k in ("slab", "tri", "sphere")], axis=1)
    assert want[:, 1].sum() > 0 and want[:, 0].min() >= 1
    np.testing.assert_array_equal(got, want)
    for k in ("slab", "tri", "sphere"):
        assert int(work[k][N:].sum()) == 0
    ops = (int(work["slab"].sum()) * t_cull.SLAB_OPS + int(work["tri"].sum()) * 38
           + int(work["sphere"].sum()) * t_cull.SPHERE_OPS)
    assert work["ops"] == ops and 0 < work["clusters"] <= tiles.shape[0]


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_cull_work_is_at_most_a_block_wide_walk(scenes, sort):
    """Each lane's own walk needs no more slab, triangle or sphere tests than
    the warp's walk, and that no more than the block's walk with all 1024
    lanes in step; the totals and bytes follow."""
    _, t_scene = scenes
    tiles = t_scene.cull_tiles
    counts, lists, entries, rays = _stage2(t_scene, scenes[0], sort, seed=23)
    lane, warp, block = (t_cull.cull_work(tiles, counts, lists, entries, rays, EPS, n_valid=N, group=g)
                         for g in (1, t_cull.WARP, t_cull.BLOCK_N))
    for k in ("slab", "tri", "sphere"):
        assert bool((lane[k] <= warp[k]).all()) and bool((warp[k] <= block[k]).all()), k
    assert lane["ops"] <= warp["ops"] <= block["ops"]
    assert lane["bytes"] <= warp["bytes"] <= block["bytes"]
    assert lane["ops"] < warp["ops"] < block["ops"]
    # the block's walk counts every lane of a block for each cluster it walks
    assert int(block["slab"].reshape(-1, t_cull.BLOCK_N).min(dim=1).values.sum()) == block["positions"]
