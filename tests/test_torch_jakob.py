"""The port's Jakob-Hanika 2019 pipeline against the JAX package, on the CPU:
the coefficient cube, the fetch, the q32 texel words, the sigmoid
evaluation, the plane-srgb scene in both texel formats, the shading
branch, one tiny render, the numpy conversion and the train step.

Tolerances: integers, words and tables exact; f32 functions rtol 1e-6.
The fetch's coefficients cancel most of their digits near zero, so they are
held within 1e-6 of each coefficient's largest magnitude.  The q32 decode
takes three sinh, whose last bits differ between XLA and torch, and the
rebased polynomial cancels again: its reflectances are held within 2e-6
absolute (the largest difference measured over these inputs is 1.5e-6).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import convert
from simple_spectral_torch import random as trandom
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import renderer as trend
from simple_spectral_torch.render import shading as tshade
from simple_spectral_torch.render import trainstep as tts
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra import upsample_jakob as tjak
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import shading as jshade
from simple_spectral_tpu.render.renderer import render_accumulate as j_render_accumulate
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra import upsample_jakob as jjak
from simple_spectral_tpu.spectra.colorimetry import build_color_tables, srgb_to_lrgb_np

RTOL = 1e-6
EVAL_ATOL = 2e-6
PLANE = dict(scene="plane-srgb", mode="jakob", width=8, height=8, spp=2, max_depth=3, els=False)


@pytest.fixture(scope="module")
def tables():
    return build_color_tables(RenderConfig(mode="jakob")), t_build_tables(TorchConfig(mode="jakob"), device="cpu")


@pytest.fixture(scope="module")
def colours():
    """4096 seeded lRGB colours: values below 0 and above 1, ties of the
    largest component (two-way and grey), and black."""
    rng = np.random.default_rng(10)
    rgb = rng.uniform(-0.2, 1.3, (4096, 3)).astype(np.float32)
    v = rng.uniform(0.0, 1.0, 256).astype(np.float32)
    rgb[0:64, 0] = rgb[0:64, 1]  # r == g
    rgb[64:128, 1] = rgb[64:128, 2]  # g == b
    rgb[128:192, 0] = rgb[128:192, 2]  # r == b
    rgb[192:448] = v[:, None]  # grey
    rgb[448:480] = 0.0  # black
    rgb[480:496] = -0.1  # black after the clamp
    return rgb


def _fetch_pair(tables, rgb):
    jt, tt = tables
    want = [np.array(c) for c in jjak.rgb2spec_fetch_soa(jt.jakob, *(jnp.asarray(rgb[:, i]) for i in range(3)))]
    got = [c.numpy() for c in tjak.rgb2spec_fetch_soa(tt.jakob, *(torch.from_numpy(rgb[:, i].copy()) for i in range(3)))]
    return want, got


def test_tables_exact(tables):
    jt, tt = tables
    assert tt.jakob["res"] == jt.jakob["res"] == 64 and isinstance(tt.jakob["res"], int)
    for k in ("scale", "coeffs"):
        assert tt.jakob[k].dtype == torch.float32
        np.testing.assert_array_equal(tt.jakob[k].numpy(), np.asarray(jt.jakob[k]))
    assert tt.meng is None and jt.meng is None


def test_fetch(tables, colours):
    want, got = _fetch_pair(tables, colours)
    black = np.clip(colours, 0.0, 1.0).max(axis=1) == 0.0
    assert black.sum() >= 48
    for c, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g[black], w[black], err_msg=f"c{c} black")
        scale = np.abs(w[~black]).max()
        np.testing.assert_allclose(g[~black], w[~black], rtol=RTOL, atol=1e-6 * scale, err_msg=f"c{c}")
    np.testing.assert_array_equal(got[2][black], -1e6)


def test_q32_pack_exact(tables, colours):
    want, _ = _fetch_pair(tables, colours)
    coeffs = [w.astype(np.float64) for w in want]
    w_j, m_j = jjak.jakob_q32_pack(*coeffs)
    w_t, m_t = tjak.jakob_q32_pack(*coeffs)
    assert w_t.dtype == np.uint32 and m_t.dtype == np.float32
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(m_t, m_j)
    assert (w_t >= 1 << 31).any()  # bit 31 is exercised
    black = np.clip(colours, 0.0, 1.0).max(axis=1) == 0.0
    np.testing.assert_array_equal((w_t & 0x7FF) == 0x7FF, black)  # the reserved black code


def test_q32_eval(tables, colours):
    want, _ = _fetch_pair(tables, colours)
    words, meta = jjak.jakob_q32_pack(*(w.astype(np.float64) for w in want))
    lam0 = np.random.default_rng(11).uniform(380.0, 480.0, len(words)).astype(np.float32)
    for n_wl, step in ((4, 100.0), (4, 110.0), (3, 400.0 / 3.0)):
        ref = np.asarray(jjak.jakob_q32_eval_soa(jnp.asarray(words), jnp.asarray(meta), jnp.asarray(lam0), n_wl, step))
        got = tjak.jakob_q32_eval_soa(torch.from_numpy(words.view(np.int32)), torch.from_numpy(meta),
                                      torch.from_numpy(lam0), n_wl, step).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=EVAL_ATOL)
        np.testing.assert_array_equal(got[:, (words & 0x7FF) == 0x7FF], 0.0)


def test_eval_and_lrgb_to_specrefl(tables, colours):
    jt, tt = tables
    want, _ = _fetch_pair(tables, colours)
    rng = np.random.default_rng(12)
    lam0 = rng.uniform(380.0, 480.0, len(colours)).astype(np.float32)
    lams = lam0[None, :] + (np.arange(4, dtype=np.float32) * 100.0)[:, None]
    ref = np.asarray(jjak.rgb2spec_eval_soa(*(jnp.asarray(w) for w in want), jnp.asarray(lams)))
    got = tjak.rgb2spec_eval_soa(*(torch.from_numpy(w) for w in want), torch.from_numpy(lams)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-7)
    lrgb = np.clip(colours, 0.0, 1.0).reshape(64, 64, 3)
    ref = np.asarray(jjak.lrgb_to_specrefl_jakob(jt, jnp.asarray(lrgb), jnp.asarray(lam0.reshape(64, 64)), 4, 100.0))
    got = tjak.lrgb_to_specrefl_jakob(tt, torch.from_numpy(lrgb), torch.from_numpy(lam0.reshape(64, 64)), 4, 100.0)
    assert got.shape == (64, 64, 4)
    # fetch then eval: the fetch's last-bit differences (held above within
    # 1e-6 of each coefficient's scale) grow by lam^2 ~ 6e5 in the sigmoid's
    # argument; measured up to 1.74e-5 here
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=3e-5)
    soa = tjak.lrgb_to_specrefl_jakob_soa(tt, TorchConfig(mode="jakob"), *(torch.from_numpy(lrgb[..., i].reshape(-1))
                                                                          for i in range(3)),
                                          torch.from_numpy(lam0))
    np.testing.assert_array_equal(soa.numpy(), got.numpy().reshape(-1, 4).T)


@pytest.fixture(scope="module", params=["u32", "rows"])
def plane(request):
    """The 8x8 plane-srgb jakob scene in one texel format, built by both
    packages, and the port's scene converted from the JAX scene's leaves."""
    cfg = RenderConfig(**PLANE, texel_format=request.param)
    tcfg = TorchConfig(**PLANE, texel_format=request.param)
    jt = build_color_tables(cfg)
    tt = t_build_tables(tcfg, device="cpu")
    js = build_scene(cfg, jt)
    return cfg, tcfg, jt, tt, js, t_build_scene(tcfg, tt, device="cpu"), convert.scene_from_numpy(_leaves(js), "cpu")


def _leaves(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "host":
            continue
        if dataclasses.is_dataclass(v):
            out[f.name] = _leaves(v)
        elif isinstance(v, dict):
            out[f.name] = {k: x if isinstance(x, (int, float)) else np.asarray(x) for k, x in v.items()}
        else:
            out[f.name] = v if v is None or isinstance(v, (int, float, str, tuple)) else np.asarray(v)
    return out


def _bits(t):
    """A tensor's values as numpy, int32 texel words as their u32 bits."""
    a = t.detach().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _u32_fields(words):
    return np.stack([(words >> 22) & 0x3FF, (words >> 11) & 0x7FF, words & 0x7FF]).astype(np.int64)


def test_plane_srgb_scene_leaves(plane):
    """Geometry, materials and camera exactly; the texture rows within the
    fetch's tolerance; the q32 words exactly where they come from the JAX
    package's coefficients, and within one code of a field where the port
    fetched its own: 59 of the texture's 262144 words move, by one code of
    one field (held to at most 0.1% of the words)."""
    cfg, _, _, tt, js, ts, _ = plane
    assert ts.n_tris == js.n_tris == 14 and ts.n_lights == js.n_lights == 6 and ts.tex_res == js.tex_res
    for f in dataclasses.fields(ts):
        got, want = getattr(ts, f.name), getattr(js, f.name)
        if f.name in ("materials", "camera"):
            for g in dataclasses.fields(got):
                a, b = getattr(got, g.name), getattr(want, g.name)
                if isinstance(a, torch.Tensor):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=g.name)
                else:
                    assert a == b, g.name
        elif f.name not in ("texture", "texel_meta"):
            if isinstance(got, torch.Tensor):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
            else:
                assert got == want or (got is None and want is None), f.name
    assert int(ts.materials.bsdf_type[1]) == 1  # the mirror quad without ELS
    want = np.asarray(js.texture)
    if cfg.texel_format == "rows":
        assert ts.texel_meta is None and js.texel_meta is None and ts.texture.shape == (512 * 512, 3)
        for c in range(3):
            w = want[:, c]
            np.testing.assert_allclose(ts.texture[:, c].numpy(), w, rtol=RTOL, atol=1e-6 * np.abs(w).max())
        return
    assert ts.texture.dtype == torch.int32 and want.dtype == np.uint32
    # the port's pack of the JAX package's own coefficients: word for word
    from PIL import Image

    from simple_spectral_tpu.spectra.spectrum import data_path

    img = np.asarray(Image.open(data_path("scenes", cfg.texture)).convert("RGB"), np.uint8).reshape(-1, 3)
    lrgb = srgb_to_lrgb_np(img.astype(np.float32) / 255.0)
    jt = build_color_tables(cfg)
    coeffs = [np.asarray(c, np.float64) for c in jjak.rgb2spec_fetch_soa(jt.jakob, *(lrgb[:, i] for i in range(3)))]
    words, meta = tjak.jakob_q32_pack(*coeffs)
    np.testing.assert_array_equal(words, want)
    np.testing.assert_array_equal(meta, np.asarray(js.texel_meta))
    # the port's own build: its fetch differs in last bits
    got = _bits(ts.texture)
    moved = np.abs(_u32_fields(got) - _u32_fields(want))
    assert moved.max() <= 1 and int((got != want).sum()) <= got.size // 1000, int((got != want).sum())
    np.testing.assert_allclose(ts.texel_meta.numpy(), np.asarray(js.texel_meta), rtol=RTOL)


def test_texture_albedo_deferred(plane):
    """The shading branch on the same texels (the port's scene converted
    from the JAX scene), with and without pre-fetched rows."""
    cfg, tcfg, jt, tt, js, _, ts = plane
    rng = np.random.default_rng(13)
    n = 2048
    idx = rng.integers(0, 512 * 512, n).astype(np.int32)
    lam0 = (cfg.lambda_min + rng.uniform(0, 1, n) * cfg.lambda_step).astype(np.float32)
    ref = np.asarray(jshade.texture_albedo_deferred(js, jt, cfg, {}, jnp.asarray(idx), jnp.asarray(lam0)))
    got = tshade.texture_albedo_deferred(ts, tt, tcfg, {}, torch.from_numpy(idx), torch.from_numpy(lam0))
    assert got.shape == (cfg.n_wavelengths, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=EVAL_ATOL)
    rows = ts.texture[torch.from_numpy(idx).to(torch.int64)]
    again = tshade.texture_albedo_deferred(ts, tt, tcfg, {}, torch.from_numpy(idx), torch.from_numpy(lam0), rows)
    assert torch.equal(again, got)


def test_render_matches_jax():
    """8x8, 2 spp, depth 3, u32 texels, no ELS: the port's render against
    the JAX render within the flip bound of tests/test_parallel.py."""
    cfg, tcfg = RenderConfig(**PLANE), TorchConfig(**PLANE)
    jt, tt = build_color_tables(cfg), t_build_tables(tcfg, device="cpu")
    v_ref, a_ref = j_render_accumulate(cfg, build_scene(cfg, jt), jt, seed=5)
    v_got, a_got = trend.render_accumulate(tcfg, t_build_scene(tcfg, tt, device="cpu"), tt, seed=5)
    assert np.isfinite(v_got).all() and v_got.mean() > 0
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_got, a_ref)


def test_convert_round_trips(plane):
    """The jakob tables (their int stays an int) and the scene, q32 words
    bit for bit, across from the JAX package and back from the port."""
    _, _, jt, tt, js, ts, from_jax = plane
    tables = convert.tables_from_numpy(_leaves(jt), device="cpu")
    assert tables.jakob["res"] == 64 and isinstance(tables.jakob["res"], int)
    for k in ("scale", "coeffs"):
        assert torch.equal(tables.jakob[k], tt.jakob[k])
    np.testing.assert_array_equal(_bits(from_jax.texture), np.asarray(js.texture))
    if js.texel_meta is not None:
        np.testing.assert_array_equal(from_jax.texel_meta.numpy(), np.asarray(js.texel_meta))
    back = convert.scene_from_numpy(convert.scene_to_numpy(ts), device="cpu")
    assert back.texture.dtype == ts.texture.dtype and torch.equal(back.texture, ts.texture)
    again = convert.tables_from_numpy(convert.tables_to_numpy(tt), device="cpu")
    assert again.jakob["res"] == 64 and torch.equal(again.jakob["coeffs"], tt.jakob["coeffs"])


def test_train_step_leaves_the_texture_out():
    """The port's train step in jakob mode on the CPU: finite loss and
    gradients, and no gradient reaches the texture (its chain is detached,
    as the JAX package's stop_gradient keeps it).  forward_backward_step
    itself runs this mode in the bench's test
    (tests/test_torch_trainstep.py)."""
    tcfg = TorchConfig(**PLANE, texel_format="rows")
    tt = t_build_tables(tcfg, device="cpu")
    ts = t_build_scene(tcfg, tt, device="cpu")
    px = torch.arange(64, dtype=torch.int32)
    target = torch.full((64, 3), 0.5)
    # forward_backward_step's loss, with the texture a leaf that asks for a
    # gradient too
    texture = ts.texture.clone().requires_grad_(True)
    params = tts._leaf_params(ts)
    with torch.enable_grad():
        loss = tts._loss_fn(dataclasses.replace(ts, texture=texture), tt, tcfg, trandom.PRNGKey(3), px, target, 2,
                            "none")(params)
        g_tex, *grads = torch.autograd.grad(loss, [texture, *params.values()], allow_unused=True)
    assert g_tex is None
    grads = dict(zip(params, grads))
    assert torch.isfinite(loss) and all(g is None or bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["emission_values"].abs().max()) > 0.0
