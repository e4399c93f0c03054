"""The port's spheres and sphere lights against the JAX package, on the CPU:
the cone-cap sampler, the sphere-light branch of NEE, the dense route
(K1's twin and the dense sphere merge) at test size and at stress scale,
and one tiny render through the block-cull arm with two sphere lights.

Both packages draw the same threefry streams.  Transcendentals (sqrt, sin,
cos, atan2) differ in the last bits between XLA and torch, so lane values
are held at rtol 1e-5 / atol 1e-6, and the render at the flip bound of
tests/test_parallel.py (at most 4 of 64 pixels off by rel >= 1e-3, none by
0.5 or more, means within 2e-3).  This file compiles one JAX render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import random as trandom
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import integrator as tint
from simple_spectral_torch.render import intersect as t_isect
from simple_spectral_torch.render import sampling as tsamp
from simple_spectral_torch.render.renderer import render_accumulate as t_render_accumulate
from simple_spectral_torch.render.vec import V3 as TV3
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import integrator as jint
from simple_spectral_tpu.render import sampling as jsamp
from simple_spectral_tpu.render.intersect import intersect_rays_soa
from simple_spectral_tpu.render.renderer import render_accumulate as j_render_accumulate
from simple_spectral_tpu.render.vec import V3
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

EPS = 1e-3
STRESS = dict(scene="cornell-stress", mode="rgb", width=8, height=8, spp=1, max_depth=3, stress_boxes=40,
              stress_spheres=20, stress_materials=16, stress_sphere_lights=2)
# hits that XLA's FMA contraction may send to another primitive on the
# dense route (measured 0; see test_dense_route_at_stress_scale)
EDGE_LANES = 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on one
    host, and these tensors are large enough for torch to fan out over
    threads that the workers then fight for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(**kw):
    args = dict(STRESS, **kw)
    cfg, tcfg = RenderConfig(**args), TorchConfig(**args)
    j_tables, t_tables = build_color_tables(cfg), t_build_tables(tcfg, device="cpu")
    return cfg, build_scene(cfg, j_tables), j_tables, tcfg, t_build_scene(tcfg, t_tables, device="cpu"), t_tables


@pytest.fixture(scope="module")
def stress():
    return _scenes(intersect_impl="cull")


def _pair(a):
    return V3(*(jnp.asarray(a[:, i]) for i in range(3))), TV3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_rand_toward_sphere_matches_jax():
    rng = np.random.default_rng(4)
    n = 2000
    to_c = rng.normal(size=(n, 3)) * rng.uniform(0.1, 300.0, size=(n, 1))
    radius = rng.uniform(1.0, 25.0, size=n).astype(np.float32)  # some origins inside their sphere
    cj, ct = _pair(to_c.astype(np.float32))
    d_j, area_j = jsamp.rand_toward_sphere(jax.random.PRNGKey(9), cj, jnp.asarray(radius))
    d_t, area_t = tsamp.rand_toward_sphere(trandom.PRNGKey(9), ct, torch.from_numpy(radius))
    _close(area_t, area_j)
    for a, b in zip(d_t, d_j):
        _close(a, b)
    inside = np.linalg.norm(to_c, axis=1) < radius
    assert inside.any() and np.allclose(area_t.numpy()[inside], 4.0 * np.pi)


def test_sphere_light_sample_matches_jax(stress):
    _, js, _, _, ts, _ = stress
    assert ts.n_sphere_lights == 2
    rng = np.random.default_rng(8)
    pos = rng.uniform((50, 20, 50), (500, 500, 500), size=(4096, 3)).astype(np.float32)
    pj, pt = _pair(pos)
    d_j, inv_j, prim_j = jint._sample_light_dir(jax.random.PRNGKey(3), js, pj)
    d_t, inv_t, prim_t = tint._sample_light_dir(trandom.PRNGKey(3), ts, pt)
    np.testing.assert_array_equal(prim_t.numpy(), np.asarray(prim_j))
    sph = np.isin(prim_t.numpy(), ts.light_prims[ts.light_kind == 1].numpy())
    assert sph.mean() > 0.5
    # the cap area and its direction agree to f32 rounding; the quad light's
    # spherical-triangle solid angle cancels to a few digits (see
    # tests/test_torch_integrator.py)
    for m, rtol in ((sph, 1e-5), (~sph, 1e-3)):
        _close(inv_t.numpy()[m], np.asarray(inv_j)[m], rtol=rtol)
        for a, b in zip(d_t, d_j):
            _close(a.numpy()[m], np.asarray(b)[m], rtol=rtol, atol=rtol)


def _rays(scene, n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform((20, 20, 20), (530, 530, 530), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ign = rng.integers(-1, scene.n_prims, size=n).astype(np.int32)
    return o, d, ign


@pytest.mark.parametrize("need_attrs", [True, False], ids=["attrs", "no-attrs"])
def test_dense_route_with_spheres_matches_jax(stress, need_attrs):
    _, js, _, _, ts, _ = stress
    o, d, ign = _rays(js, 1500, seed=21)
    (oj, ot), (dj, dt) = _pair(o), _pair(d)
    ref = intersect_rays_soa(js, oj, dj, jnp.asarray(ign), EPS, need_attrs=need_attrs)
    got = t_isect.intersect_rays_dispatch(ts, ot, dt, torch.from_numpy(ign), EPS, need_attrs=need_attrs,
                                          impl="xla")
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(ref.hit))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    sph = np.isin(got.prim.numpy(), ts.sphere_prim.numpy())
    assert sph.sum() > 10
    m = np.asarray(ref.hit)
    # "xla" takes K1's exact key, so the key's distance (no attrs) is exact too
    _close(got.dist.numpy()[m], np.asarray(ref.dist)[m], rtol=1e-5)
    if need_attrs:
        for a, b in zip(got.normal, ref.normal):
            _close(a.numpy()[sph], np.asarray(b)[sph])
        _close(got.st_s.numpy()[sph], np.asarray(ref.st_s)[sph])


def test_dense_route_at_stress_scale():
    """cornell-stress at its default 1000 boxes (10,038 triangles, 500
    spheres) below the cull threshold: "auto" takes K1's exact 64-bit key,
    whose winner is JAX's ``xla`` sweep's ``jnp.argmin``, so every hit goes
    to the same primitive.  XLA on the CPU contracts ``a*b + c`` into FMAs,
    which moves a distance by up to 3.8e-5 relative; over seeds 31 and
    40-45 (13,492 hits) that sent no hit to another primitive, so the test
    allows EDGE_LANES = 0 of them."""
    cfg, tcfg = (c(scene="cornell-stress", mode="rgb", width=8, height=8, stress_boxes=1000,
                   bvh_threshold=1 << 30) for c in (RenderConfig, TorchConfig))
    js = build_scene(cfg, build_color_tables(cfg))
    ts = t_build_scene(tcfg, t_build_tables(tcfg, device="cpu"), device="cpu")
    assert ts.n_tris == 10038 and ts.n_spheres == 500 and ts.cull_tiles is None
    o, d, ign = _rays(js, 2048, seed=31)
    sweep = jax.jit(lambda a, b, c: intersect_rays_soa(js, a, b, c, EPS, need_attrs=False))
    hit, hit_ref, other = 0, 0, 0
    for lo in range(0, o.shape[0], 512):  # bounds the twin's [T, N] grids
        sl = slice(lo, lo + 512)
        (oj, ot), (dj, dt) = _pair(o[sl]), _pair(d[sl])
        ref = sweep(oj, dj, jnp.asarray(ign[sl]))
        got = t_isect.intersect_rays_dispatch(ts, ot, dt, torch.from_numpy(ign[sl]), EPS, need_attrs=False,
                                              impl="auto")
        hit += int(got.hit.sum())
        hit_ref += int(np.asarray(ref.hit).sum())
        other += int((got.prim.numpy() != np.asarray(ref.prim)).sum())
        m = np.asarray(ref.hit)
        _close(got.dist.numpy()[m], np.asarray(ref.dist)[m], rtol=1e-4)
    print(f"dense route at stress scale: {other} of {hit_ref} hits on another primitive")
    assert hit == hit_ref
    assert other <= EDGE_LANES


def test_render_through_cull_with_sphere_lights_matches_jax(stress):
    cfg, js, jt, tcfg, ts, tt = stress
    v_ref, a_ref = j_render_accumulate(cfg, js, jt, seed=3)
    v_got, a_got = t_render_accumulate(tcfg, ts, tt, seed=3)
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_got, a_ref)
