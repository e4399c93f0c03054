"""The port's samplers, shading, integrator and renderer against the JAX
package, on the CPU, at a tiny size (8x8 pixels, 1-2 spp, depth 3).

Both packages draw the same threefry streams, so a lane here traces the
same path as the same lane there.  The values still differ in the last bits:
XLA on the CPU contracts ``a*b + c`` into fused multiply-adds and has its
own acos/sin/cos/rsqrt, each a few ulp from torch's, and the NEE solid angle
``alpha + beta + gamma - pi`` (render/sampling.py spherical_triangle)
cancels most of its digits for a small or distant light.  Measured over 40
seeds at this size (64 lanes each): the median lane agrees to ~1e-5, the
second-worst lane of a seed reaches 1.6e-2, and one lane in a seed may take
another path after a grazing hit.  The lane test holds that profile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import random as trandom
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import integrator as tint
from simple_spectral_torch.render import renderer as trend
from simple_spectral_torch.render import sampling as tsamp
from simple_spectral_torch.render import shading as tshade
from simple_spectral_torch.render.vec import V3 as TV3
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import integrator as jint
from simple_spectral_tpu.render import sampling as jsamp
from simple_spectral_tpu.render import shading as jshade
from simple_spectral_tpu.render.renderer import render_accumulate as j_render_accumulate
from simple_spectral_tpu.render.renderer import render_image as j_render_image
from simple_spectral_tpu.render.vec import V3
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

RTOL = 1e-5
TINY = dict(width=8, height=8, spp=1, max_depth=3)
CASES = {"cornell-srgb-mallett": ("cornell-srgb", "mallett"), "cornell-rgb": ("cornell", "rgb")}


def _build(scene_name, mode, **kw):
    args = dict(TINY, scene=scene_name, mode=mode, **kw)
    cfg = RenderConfig(**args, intersect_impl="xla2")
    j_tables = build_color_tables(cfg)
    tcfg = TorchConfig(**args, intersect_impl="xla2")
    t_tables = t_build_tables(tcfg, device="cpu")
    return cfg, build_scene(cfg, j_tables), j_tables, tcfg, t_build_scene(tcfg, t_tables, device="cpu"), t_tables


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def lanes(request):
    """JAX trace_lanes (intersect_impl="xla2", one compile per case) and the
    port's on the same name (K1's quantized key, as ``intersect_rays_soa2``
    keys), on the same key and pixels."""
    cfg, js, jt, tcfg, ts, tt = _build(*CASES[request.param])
    px = np.arange(cfg.width * cfg.height, dtype=np.int32)
    seed = 11
    trace = jax.jit(jint.trace_lanes, static_argnums=(2,))
    ref = trace(js, jt, cfg, jax.random.PRNGKey(seed), jnp.asarray(px % cfg.width), jnp.asarray(px // cfg.width))
    got = tint.trace_lanes(ts, tt, tcfg, trandom.PRNGKey(seed), torch.from_numpy(px % cfg.width),
                           torch.from_numpy(px // cfg.width))
    return ref, got


@pytest.fixture(scope="module")
def srgb_mallett():
    return _build("cornell-srgb", "mallett")


def test_trace_lanes_alpha_exact(lanes):
    ref, got = lanes
    np.testing.assert_array_equal(got.alpha.numpy(), np.asarray(ref.alpha))


def test_trace_lanes_lane_by_lane(lanes):
    ref, got = lanes
    want, have = np.asarray(ref.value), got.value.numpy()
    assert np.isfinite(have).all()
    rel = (np.abs(have - want) / (np.abs(want) + 1e-3 * np.abs(want).max())).max(axis=1)
    worst = np.sort(rel)[::-1]
    assert np.median(rel) < 1e-4, f"median lane rel {np.median(rel):.2e}"
    assert worst[1] < 2e-2, f"second-worst lane rel {worst[1]:.2e} (one lane may take another path)"
    np.testing.assert_allclose(have.mean(axis=0), want.mean(axis=0), rtol=2e-2)


def test_render_image_matches_jax_auto(srgb_mallett):
    """render_image against JAX's default ("auto") render within the flip
    bound of tests/test_parallel.py."""
    cfg, js, jt, tcfg, ts, tt = srgb_mallett
    cfg, tcfg = cfg.replace(intersect_impl="auto", spp=2), tcfg.replace(intersect_impl="auto", spp=2)
    v_ref, a_ref = j_render_accumulate(cfg, js, jt, seed=5)
    v_got, a_got = trend.render_accumulate(tcfg, ts, tt, seed=5)
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_got, a_ref)
    fb_ref = j_render_image(cfg, js, jt, seed=5)
    fb_got = trend.render_image(tcfg, ts, tt, seed=5, device="cpu")
    assert fb_got.shape == fb_ref.shape == (8, 8, 4) and fb_got.dtype == np.float32
    close = (np.abs(fb_got - fb_ref) < 1e-3).all(axis=-1)
    assert int((~close).sum()) <= 4


def test_render_image_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trend.render_image(TorchConfig(**TINY, scene="cornell", mode="rgb"))


# --- samplers and shading, same keys and inputs on both sides ---


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _pair(a):
    return V3(*(jnp.asarray(a[:, i]) for i in range(3))), TV3(*(torch.from_numpy(a[:, i].copy()) for i in range(3)))


def _close(got, want, rtol=RTOL, atol=1e-6):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_lane_math():
    rng = np.random.default_rng(0)
    nj, nt = _pair(_unit(rng, 333))
    vj, vt = _pair(_unit(rng, 333))
    _close(tsamp.onb_from_y(nt), jsamp.onb_from_y(nj))
    _close(tsamp.rotated_to(vt, nt), jsamp.rotated_to(vj, nj))
    _close(tsamp.reflect(vt, nt), jsamp.reflect(vj, nj))
    assert tsamp.PI_UNDER == jsamp.PI_UNDER
    d_j, pdf_j = jsamp.rand_coshemi(jax.random.PRNGKey(3), (333,), 1e-3)
    d_t, pdf_t = tsamp.rand_coshemi(trandom.PRNGKey(3), (333,), 1e-3, "cpu")
    _close(d_t, d_j)
    _close(pdf_t, pdf_j)


def test_spherical_triangle_sampling():
    rng = np.random.default_rng(1)
    (aj, at), (bj, bt), (cj, ct) = (_pair(_unit(rng, 257)) for _ in range(3))
    tri_j, tri_t = jsamp.spherical_triangle(aj, bj, cj), tsamp.spherical_triangle(at, bt, ct)
    np.testing.assert_array_equal(tri_t.degenerate.numpy(), np.asarray(tri_j.degenerate))
    for name in ("cos_c", "cos_alpha"):
        _close(getattr(tri_t, name), getattr(tri_j, name), atol=1e-6)
    for name in ("b", "alpha"):  # arccos near +-1: a few ulp of the cosine
        _close(getattr(tri_t, name), getattr(tri_j, name), rtol=1e-4, atol=1e-6)
    _close(tri_t.area, tri_j.area, rtol=1e-4, atol=1e-5)  # alpha + beta + gamma - pi cancels
    # The sampler on one and the same triangle (JAX's), so that the area's
    # cancellation above is not counted twice: a sliver's area differs by
    # ~0.4% between the two packages, and Arvo's map amplifies that.
    same = tsamp.SphericalTriangle(*(
        TV3(*(torch.from_numpy(np.array(c)) for c in f)) if isinstance(f, V3) else torch.from_numpy(np.array(f))
        for f in tri_j
    ))
    _close(tsamp.rand_toward_spherical_triangle(trandom.PRNGKey(9), same),
           jsamp.rand_toward_spherical_triangle(jax.random.PRNGKey(9), tri_j), rtol=1e-4, atol=1e-4)


def test_camera_rays_and_light_sampling(srgb_mallett):
    cfg, js, jt, tcfg, ts, tt = srgb_mallett
    px = np.arange(64, dtype=np.int32)
    oj, dj = jint.camera_rays_soa(js, cfg, jax.random.PRNGKey(2), jnp.asarray(px % 8), jnp.asarray(px // 8))
    ot, dt = tint.camera_rays_soa(ts, tcfg, trandom.PRNGKey(2), torch.from_numpy(px % 8), torch.from_numpy(px // 8))
    _close(ot, oj, rtol=0, atol=0)
    _close(dt, dj)
    rng = np.random.default_rng(4)
    pos = rng.uniform([10, 10, 10], [540, 500, 550], size=(300, 3)).astype(np.float32)
    pj, pt = _pair(pos)
    d_j, inv_j, prim_j = jint._sample_light_dir(jax.random.PRNGKey(6), js, pj)
    d_t, inv_t, prim_t = tint._sample_light_dir(trandom.PRNGKey(6), ts, pt)
    np.testing.assert_array_equal(prim_t.numpy(), np.asarray(prim_j))
    _close(d_t, d_j, rtol=1e-4, atol=1e-4)
    _close(inv_t, inv_j, rtol=1e-3, atol=1e-6)  # the solid angle's cancellation


@pytest.mark.parametrize("form", ["shifted-window", "common-general", "per-material"])
def test_precompute_constant_spectra(srgb_mallett, form):
    cfg, js, jt, tcfg, ts, tt = srgb_mallett
    if form == "common-general":  # one hero wavelength: no shifted window
        cfg, tcfg = cfg.replace(n_wavelengths=1), tcfg.replace(n_wavelengths=1)
    if form == "per-material":  # no shared lattice
        js = js.__class__(**{**js.__dict__, "materials": js.materials.__class__(
            **{**js.materials.__dict__, "albedo_grid": None, "emission_grid": None})})
        ts = ts.__class__(**{**ts.__dict__, "materials": ts.materials.__class__(
            **{**ts.materials.__dict__, "albedo_grid": None, "emission_grid": None})})
    lam0 = (cfg.lambda_min + np.random.default_rng(5).uniform(0, 1, 200) * cfg.lambda_step).astype(np.float32)
    want = jshade.precompute_constant_spectra(js, cfg, jnp.asarray(lam0))
    got = tshade.precompute_constant_spectra(ts, tcfg, torch.from_numpy(lam0))
    for k in ("albedo", "emission"):
        _close(got[k], want[k], rtol=RTOL, atol=1e-5)
    _close(tshade.precompute_basis_hero(tt, tcfg, torch.from_numpy(lam0)),
           jshade.precompute_basis_hero(jt, cfg, jnp.asarray(lam0)), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("mode", ["rgb", "mallett"])
def test_texture_and_material_selection(mode):
    cfg, js, jt, tcfg, ts, tt = _build("cornell-srgb", mode)
    rng = np.random.default_rng(6)
    n = 500
    st_s, st_t = rng.uniform(-0.1, 1.1, size=(2, n)).astype(np.float32)
    idx_j = jshade.texel_index(js, jnp.asarray(st_s), jnp.asarray(st_t))
    idx_t = tshade.texel_index(ts, torch.from_numpy(st_s), torch.from_numpy(st_t))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(tshade.texel_fetch_lrgb(ts, idx_t), jshade.texel_fetch_lrgb(js, idx_j), atol=1e-7)
    lam0 = (cfg.lambda_min + rng.uniform(0, 1, n) * cfg.lambda_step).astype(np.float32)
    cache_j = {"basis_hero": jshade.precompute_basis_hero(jt, cfg, jnp.asarray(lam0))} if mode == "mallett" else {}
    cache_t = {"basis_hero": tshade.precompute_basis_hero(tt, tcfg, torch.from_numpy(lam0))} if mode == "mallett" else {}
    _close(tshade.texture_albedo_deferred(ts, tt, tcfg, cache_t, idx_t, torch.from_numpy(lam0)),
           jshade.texture_albedo_deferred(js, jt, cfg, cache_j, idx_j, jnp.asarray(lam0)), atol=1e-6)
    mat = rng.integers(0, ts.materials.n_materials, n).astype(np.int32)
    mj, mt = jnp.asarray(mat), torch.from_numpy(mat)
    np.testing.assert_array_equal(tshade.is_mirror_mask(ts, mt).numpy(), np.asarray(jshade.is_mirror_mask(js, mj)))
    np.testing.assert_array_equal(tshade.is_textured_mask(ts, mt).numpy(),
                                  np.asarray(jshade.is_textured_mask(js, mj)))
    np.testing.assert_array_equal(tshade.material_onehot(7, mt).numpy(), np.asarray(jshade.material_onehot(7, mj)))
    np.testing.assert_array_equal(tshade.select_column(ts.materials.bsdf_type, mt, ts.materials.n_materials).numpy(),
                                  np.asarray(jshade.select_column(js.materials.bsdf_type, mj, 8)))
    normal_j, normal_t = _pair(_unit(rng, n))
    wo_j, wo_t = _pair(_unit(rng, n))
    mirror = rng.uniform(size=n) < 0.3
    got = tshade.sample_bsdf_direction(trandom.PRNGKey(8), tcfg, torch.from_numpy(mirror), wo_t, normal_t)
    want = jshade.sample_bsdf_direction(jax.random.PRNGKey(8), cfg, jnp.asarray(mirror), wo_j, normal_j)
    _close(got[0], want[0], atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy()[mirror], np.asarray(want[1])[mirror])
    _close(got[1][~torch.from_numpy(mirror)], np.asarray(want[1])[~mirror])


@pytest.mark.parametrize("n_materials", [7, 20], ids=["masked-sum", "contraction"])
@pytest.mark.parametrize("per_lane", [False, True], ids=["rgb-table", "spectra-cache"])
def test_mat_rows_forms(n_materials, per_lane):
    rng = np.random.default_rng(n_materials)
    n = 97
    mat = rng.integers(0, n_materials, n)
    if per_lane:
        table = rng.uniform(size=(n_materials, 4, n)).astype(np.float32)
        want = table[mat, :, np.arange(n)].T
    else:
        table = rng.uniform(size=(n_materials, 3)).astype(np.float32)
        want = table[mat].T
    got = tint._mat_rows(torch.from_numpy(table), torch.from_numpy(mat.astype(np.int32)), n_materials)
    np.testing.assert_array_equal(got.numpy(), want)
