"""The BVH arm (``intersect_impl="bvh"``): the port's skip-link walk
``intersect_rays_bvh`` against the JAX package's, and against the port's
exact dense route, on the CPU.

Two scenes: cornell with a forced BVH (50 entries) and a small cornell-stress
past ``bvh_threshold`` with spheres (638 triangles, 30 spheres, 931 entries).
Rays: seeded random rays inside the scene, and bounce rays leaving their
first hit with its primitive ignored.

Against JAX the winners (hit, prim, mat, tri) may differ on at most
EDGE_FLIPS lanes (XLA on the CPU contracts ``a*b + c`` in the watertight
and sphere tests, which can flip a ray grazing an edge), and distances agree
within DIST_ULPS units in the last place of the scene's extent (~556; the
largest seen over four seeds is 3 on cornell and 53.5 on the stress scene,
where the sphere roots cancel digits; no winner flipped).
Against the exact dense route (K1's exact key with the sphere sweep, the
same f32 operations in the same order) every hit distance is equal bit for
bit, and the winners differ only between exactly equal distances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import bvh as tbvh
from simple_spectral_torch.render import intersect as t_isect
from simple_spectral_torch.render.renderer import render_accumulate
from simple_spectral_torch.render.vec import V3 as TV3
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render.bvh import intersect_rays_bvh
from simple_spectral_tpu.render.vec import V3
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

EPS = 1e-3
N_RAYS = 1024
EDGE_FLIPS = 2
DIST_ULPS = 64
SCENES = {
    "cornell": dict(scene="cornell", mode="rgb", intersect_impl="bvh"),
    "stress": dict(scene="cornell-stress", mode="rgb", stress_boxes=60, stress_spheres=30),
}


@pytest.fixture(scope="module", params=list(SCENES))
def scenes(request):
    kw = SCENES[request.param]
    cfg, tcfg = RenderConfig(**kw), TorchConfig(**kw)
    ts = t_build_scene(tcfg, t_build_tables(tcfg, device="cpu"), device="cpu")
    assert ts.bvh_nodes is not None and ts.n_bvh_entries > ts.n_tris + ts.n_spheres
    return build_scene(cfg, build_color_tables(cfg)), ts


def _rays(ts, seed):
    """Random rays inside the scene, then bounce rays from their hits: both
    halves of one batch, so that one JAX compile serves a scene."""
    rng = np.random.default_rng(seed)
    verts = ts.tri_verts.reshape(-1, 3).numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    half = N_RAYS // 2
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=(half, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    first = t_isect.intersect_rays(ts, torch.from_numpy(o), torch.from_numpy(d[:half]),
                                   torch.full((half,), -1, dtype=torch.int32), EPS)
    dist = torch.where(first.hit, first.dist, 0.0).numpy()
    o = np.concatenate([o, o + dist[:, None] * d[:half]]).astype(np.float32)
    ignore = np.concatenate([np.full(half, -1, np.int32), first.prim.numpy()])
    return o, d, ignore


def _torch(o, d, ignore):
    return (TV3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])) for i in range(3))),
            TV3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])) for i in range(3))), torch.from_numpy(ignore))


def test_walk_matches_jax(scenes):
    js, ts = scenes
    o, d, ignore = _rays(ts, 11)
    ref = intersect_rays_bvh(js, V3(*(jnp.asarray(o[:, i]) for i in range(3))),
                             V3(*(jnp.asarray(d[:, i]) for i in range(3))), jnp.asarray(ignore), EPS)
    got = tbvh.intersect_rays_bvh(ts, *_torch(o, d, ignore), EPS)
    same = np.ones(N_RAYS, bool)
    for name in ("hit", "prim", "mat", "tri"):
        same &= getattr(got, name).numpy() == np.asarray(getattr(ref, name))
    assert (~same).sum() <= EDGE_FLIPS, f"{(~same).sum()} lanes with another winner"
    hit = same & np.asarray(ref.hit)
    assert hit.sum() > N_RAYS // 2
    extent = float((ts.tri_verts.reshape(-1, 3).amax(0) - ts.tri_verts.reshape(-1, 3).amin(0)).max())
    ulps = np.abs(got.dist.numpy()[hit] - np.asarray(ref.dist)[hit]) / np.spacing(np.float32(extent))
    assert ulps.max() <= DIST_ULPS, f"{ulps.max()} ulp of the extent"
    # a sphere's normal and ST follow its hit point: a distance apart by δ
    # moves them by about δ / radius (radii from ~5; δ up to ~4e-3 above)
    for a in range(3):
        np.testing.assert_allclose(got.normal[a].numpy()[hit], np.asarray(ref.normal[a])[hit], atol=1e-3)
    np.testing.assert_allclose(got.st_s.numpy()[hit], np.asarray(ref.st_s)[hit], atol=1e-3)


def test_walk_matches_the_exact_dense_route_up_to_ties(scenes):
    _, ts = scenes
    o, d, ignore = _torch(*_rays(ts, 12))
    got = t_isect.intersect_rays_dispatch(ts, o, d, ignore, EPS, impl="bvh")
    want = t_isect.intersect_rays_dispatch(ts, o, d, ignore, EPS, impl="xla")
    assert torch.equal(got.hit, want.hit) and torch.equal(got.dist, want.dist)
    same = (got.prim == want.prim) & (got.tri == want.tri)
    # another winner only at an exactly equal distance (a tie): the
    # dense route takes the lower index, the walk the first in DFS order
    assert int((~same).sum()) <= 2
    hit = same & got.hit
    for a, b in ((got.mat, want.mat), (got.st_s, want.st_s), (got.st_t, want.st_t), *zip(got.normal, want.normal)):
        assert torch.equal(a[hit], b[hit])
    best_entry, best_dist, steps = tbvh.bvh_walk(ts, o, d, ignore, EPS)
    assert torch.equal(best_dist, got.dist) and 0 < steps <= ts.n_bvh_entries


def test_bvh_routing_and_a_tiny_render():
    """"bvh" resolves to the walk, needs the scene's BVH, and a tiny render
    through it agrees with the dense render within the flip bound."""
    assert t_isect.resolve_intersect_impl("bvh") == "bvh"
    kw = dict(scene="cornell-stress", mode="rgb", width=8, height=8, spp=2, max_depth=3, stress_boxes=60,
              stress_spheres=30)
    tcfg = TorchConfig(**kw)
    tables = t_build_tables(tcfg, device="cpu")
    scene = t_build_scene(tcfg, tables, device="cpu")
    v_bvh, a_bvh = render_accumulate(tcfg.replace(intersect_impl="bvh"), scene, tables, seed=4)
    v_ref, a_ref = render_accumulate(tcfg.replace(intersect_impl="xla"), scene, tables, seed=4)
    rel = np.abs(v_bvh - v_ref) / (np.abs(v_ref) + 1e-3)
    assert int((~(rel < 1e-3).all(axis=-1)).sum()) <= 4 and (rel < 0.5).all()
    np.testing.assert_allclose(v_bvh.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_bvh, a_ref)

    no_bvh = t_build_scene(TorchConfig(scene="cornell", mode="rgb"), tables, device="cpu")
    o = TV3(*(torch.zeros(2) for _ in range(3)))
    d = TV3(torch.zeros(2), torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError, match="has no BVH"):
        t_isect.intersect_rays_dispatch(no_bvh, o, d, torch.full((2,), -1, dtype=torch.int32), EPS, impl="bvh")
    # the quantized dense names refuse spheres, as in the JAX package
    for impl in ("xla2", "pallas"):
        with pytest.raises(ValueError, match=f"intersect_impl='{impl}' does not support spheres; use bvh/xla"):
            t_isect.intersect_rays_dispatch(scene, o, d, torch.full((2,), -1, dtype=torch.int32), EPS, impl=impl)
