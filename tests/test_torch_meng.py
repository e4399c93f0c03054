"""The port's Meng 2015 pipeline against the JAX package, on the CPU: the
grid tables, the grid evaluation, both cell-weight walks, the legacy
matrices, the shading branch in both texel formats under both observers,
the chunk cap, one tiny render, the numpy conversion and the train step;
then M1's plain twin (``upsample_meng.meng_albedo_hero_plain``) against the
unfactored grid evaluation, its decode table, the wrapper's refusals, and
an import of the port without ``nvcc`` or JAX.

Tolerances: integers, point ids and tables exact; f32 functions rtol 1e-6;
cell weights atol 1e-5, the JAX package's own bound
(tests/test_texel_q32.py); images within the flip bound of
tests/test_parallel.py.
"""

import dataclasses
import os
import subprocess
import sys

import jax
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
from simple_spectral_torch.spectra import colorimetry as tcol
from simple_spectral_torch.spectra import upsample_meng as tmeng
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import renderer as jrend
from simple_spectral_tpu.render import shading as jshade
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra import colorimetry as jcol
from simple_spectral_tpu.spectra import upsample_meng as jmeng

RTOL = 1e-6
W_ATOL = 1e-5
SRGB = dict(scene="cornell-srgb", mode="meng", width=8, height=8, spp=2, max_depth=3)


@pytest.fixture(scope="module")
def tables():
    return jcol.build_color_tables(RenderConfig(mode="meng")), tcol.build_color_tables(TorchConfig(mode="meng"),
                                                                                        device="cpu")


@pytest.fixture(scope="module")
def xyz(tables):
    """Seeded XYZ: Meng's matrix on random lRGB (inner cells), saturated
    primaries and their mixes (boundary fan cells), chromaticities off the
    grid, and black."""
    rng = np.random.default_rng(20)
    lrgb = rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32)
    lrgb[:256] = 0.0
    lrgb[np.arange(256), rng.integers(0, 3, 256)] = rng.uniform(0.05, 1.0, 256)  # primaries
    lrgb[256:512, rng.integers(0, 3)] *= 0.02  # near the locus
    x, y, z = (np.array(v) for v in jmeng.lrgb_to_xyz_meng(*(jnp.asarray(lrgb[:, i]) for i in range(3))))
    x[512:600] = rng.uniform(0.0, 100.0, 88)
    y[512:600] = rng.uniform(0.0, 0.5, 88)  # below the locus: off the grid
    z[512:600] = rng.uniform(0.0, 100.0, 88)
    x[600:620] = y[600:620] = z[600:620] = 0.0  # black
    return lrgb, (x, y, z)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tables_exact(tables):
    jt, tt = tables
    jm, tm = jt.meng, tt.meng
    assert set(tm) == set(jm)
    for k, v in jm.items():
        if isinstance(v, (int, float)):
            assert tm[k] == v and type(tm[k]) is type(v), k
        else:
            assert tm[k].dtype == {np.int32: torch.int32, np.float32: torch.float32}[np.asarray(v).dtype.type], k
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(v), err_msg=k)
    assert (tm["lam_min"], tm["lam_max"], tm["pts_spectrum"].shape[1]) == jmeng.meng_grid_meta() == (380.0, 780.0, 81)
    assert tt.jakob is None


def test_spectrum_xyz_to_p(tables, xyz):
    jt, tt = tables
    _, (x, y, z) = xyz
    rng = np.random.default_rng(21)
    for lam_lo, step in ((380.0, 100.0), (390.0, 110.0)):  # both observers' hero ranges
        lam0 = (lam_lo + rng.uniform(0, 1, len(x)) * step).astype(np.float32)
        lams = lam0[None, :] + (np.arange(4, dtype=np.float32) * step)[:, None]
        ref = np.asarray(jax.jit(lambda *a: jmeng.spectrum_xyz_to_p_soa(jt.meng, *a))(
            *(jnp.asarray(v) for v in (x, y, z)), jnp.asarray(lams)))
        got = tmeng.spectrum_xyz_to_p_soa(tt.meng, _t(x), _t(y), _t(z), _t(lams)).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6 * np.abs(ref).max())
        assert (got[:, 512:620] == 0.0).mean() > 0.5  # off the grid and black give zero


@pytest.mark.parametrize("walk", ["meng_cell_weights_soa", "meng_cell_weights_soa_onehot"])
def test_cell_weights(tables, xyz, walk):
    jt, tt = tables
    _, (x, y, z) = xyz
    p_ref, w_ref = getattr(jmeng, walk)(jt.meng, *(jnp.asarray(v) for v in (x, y, z)))
    p_got, w_got = getattr(tmeng, walk)(tt.meng, _t(x), _t(y), _t(z))
    assert p_got.dtype == torch.int32 and p_got.shape == w_got.shape == (6, len(x))
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(w_got.numpy(), np.asarray(w_ref), rtol=0, atol=W_ATOL)
    # boundary fan cells and off-grid lanes are both exercised
    cells = tmeng._uv_position(tt.meng, _t(x), _t(y), _t(z))[4].to(torch.int64)
    assert (tt.meng["grid_inside"][cells] == 0).any() and (tt.meng["grid_inside"][cells] > 0).any()
    assert (w_got.abs().sum(dim=0) == 0).any()


def test_the_two_walks_agree(tables, xyz):
    """One walk serves both JAX names: the cell's row of ``cell_chan`` holds
    bit for bit what reading the grid's tables one by one returns."""
    _, tt = tables
    _, (x, y, z) = xyz
    assert tmeng.meng_cell_weights_soa_onehot is tmeng.meng_cell_weights_soa
    m = tt.meng
    cell = tmeng._uv_position(m, _t(x), _t(y), _t(z))[4].to(torch.int64)
    inside, num, pidx, pu, pv = tmeng._cell_values(m, cell)
    assert torch.equal(inside, m["grid_inside"][cell]) and torch.equal(num, m["grid_num"][cell])
    gi = torch.clamp_min(m["grid_idx"][cell], 0)
    for s in range(6):
        assert torch.equal(pidx[s], gi[:, s])
        assert torch.equal(pu[s], m["pts_uv"][gi[:, s].to(torch.int64), 0])
        assert torch.equal(pv[s], m["pts_uv"][gi[:, s].to(torch.int64), 1])


def test_legacy_matrices(tables, xyz):
    jt, tt = tables
    lrgb, _ = xyz
    ref = jmeng.lrgb_to_xyz_meng(*(jnp.asarray(lrgb[:, i]) for i in range(3)))
    got = tmeng.lrgb_to_xyz_meng(*(_t(lrgb[:, i]) for i in range(3)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    np.testing.assert_array_equal(tcol.MENG_M_RGB_TO_XYZ, jcol.MENG_M_RGB_TO_XYZ)
    np.testing.assert_array_equal(tcol.MENG_M_XYZ_TO_RGB, jcol.MENG_M_XYZ_TO_RGB)
    v = np.random.default_rng(22).uniform(0.0, 3.0, (8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(tcol.ciexyz_to_srgb(tt, _t(v), "meng").numpy(),
                               np.asarray(jcol.ciexyz_to_srgb(jt, jnp.asarray(v), "meng")), rtol=RTOL, atol=1e-7)
    # the meng branch differs from the other modes' matrix
    assert not np.allclose(tcol.ciexyz_to_srgb(tt, _t(v), "meng").numpy(),
                           tcol.ciexyz_to_srgb(tt, _t(v), "mallett").numpy())
    lams = np.full((4, len(lrgb)), 500.0, np.float32)
    np.testing.assert_allclose(
        tmeng.lrgb_to_specrefl_meng(tt, _t(lrgb), _t(lams[0]), 4, 100.0).numpy(),
        np.asarray(jax.jit(lambda a, b: jmeng.lrgb_to_specrefl_meng(jt, a, b, 4, 100.0))(jnp.asarray(lrgb),
                                                                                         jnp.asarray(lams[0]))),
        rtol=RTOL, atol=1e-6)


# (observer, texel format, hero wavelengths): both observers, whose hero
# wavelengths reach past the table's 780 nm under CIE 2006 (the edge clamp);
# 3 wavelengths under CIE 1931 step by no whole number of bins
SHADING = [(1931, "u32", 4), (1931, "rows", 4), (2006, "u32", 4), (2006, "rows", 4), (1931, "u32", 3)]


@pytest.mark.parametrize("observer, fmt, n_wl", SHADING, ids=[f"{o}-{f}-{s}wl" for o, f, s in SHADING])
def test_texture_albedo_deferred(observer, fmt, n_wl):
    kw = dict(SRGB, observer=observer, texel_format=fmt, n_wavelengths=n_wl)
    cfg, tcfg = RenderConfig(**kw), TorchConfig(**kw)
    jt, tt = jcol.build_color_tables(cfg), tcol.build_color_tables(tcfg, device="cpu")
    js = build_scene(cfg, jt)
    ts = convert.scene_from_numpy(_leaves(js), device="cpu")
    rng = np.random.default_rng(23)
    n = 1024
    idx = rng.integers(0, 512 * 512, n).astype(np.int32)
    lam0 = (cfg.lambda_min + rng.uniform(0, 1, n) * cfg.lambda_step).astype(np.float32)
    ref = np.asarray(jax.jit(lambda i, lam: jshade.texture_albedo_deferred(js, jt, cfg, {}, i, lam))(
        jnp.asarray(idx), jnp.asarray(lam0)))
    got = tshade.texture_albedo_deferred(ts, tt, tcfg, {}, _t(idx), _t(lam0))
    assert got.shape == (n_wl, n)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-6 * np.abs(ref).max())
    if (observer, fmt) == (2006, "rows"):  # the port's own build-time walk gives the same rows
        own = t_build_scene(tcfg, tt, device="cpu").texture
        np.testing.assert_array_equal(own[:, :6].numpy(), np.asarray(js.texture)[:, :6])
        np.testing.assert_allclose(own[:, 6:].numpy(), np.asarray(js.texture)[:, 6:], rtol=0, atol=W_ATOL)


def test_render_chunk_lanes_cap():
    """The textured meng pipeline caps a chunk at 2^18 lanes, as in the JAX
    package; meng without a texture and the other modes do not."""
    for scene, mode in (("cornell-srgb", "meng"), ("cornell", "meng"), ("cornell-srgb", "mallett")):
        kw = dict(scene=scene, mode=mode, width=8, height=8)
        cfg, tcfg = RenderConfig(**kw), TorchConfig(**kw)
        ts = t_build_scene(tcfg, tcol.build_color_tables(tcfg, device="cpu"), device="cpu")
        js = build_scene(cfg, jcol.build_color_tables(cfg))
        assert trend.render_chunk_lanes(tcfg, ts) == jrend.render_chunk_lanes(cfg, js)
        assert trend.render_chunk_lanes(tcfg, ts) == (1 << 18 if ts.texture is not None and mode == "meng"
                                                      else tcfg.max_lanes)


def test_render_matches_jax():
    """cornell-srgb, meng, CIE 2006, u32 texels, 8x8, 2 spp, depth 3: the
    port's render against the JAX render within the flip bound of
    tests/test_parallel.py, then the meng sRGB conversion of both."""
    kw = dict(SRGB, observer=2006)
    cfg, tcfg = RenderConfig(**kw), TorchConfig(**kw)
    jt, tt = jcol.build_color_tables(cfg), tcol.build_color_tables(tcfg, device="cpu")
    v_ref, a_ref = jrend.render_accumulate(cfg, build_scene(cfg, jt), jt, seed=5)
    v_got, a_got = trend.render_accumulate(tcfg, t_build_scene(tcfg, tt, device="cpu"), tt, seed=5)
    assert np.isfinite(v_got).all() and v_got.mean() > 0
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_got, a_ref)
    fb_ref = np.asarray(jrend.finalize_srgb(cfg, jt, v_ref, a_ref))
    fb_got = trend.finalize_srgb(tcfg, tt, v_ref, a_ref)
    np.testing.assert_allclose(fb_got, fb_ref, rtol=RTOL, atol=1e-6)


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


@pytest.mark.parametrize("fmt", ["u32", "rows"])
def test_convert_round_trips(tables, fmt):
    """The meng tables (ints and floats stay Python numbers) and the scene
    in both texel formats, across from the JAX package and back."""
    jt, tt = tables
    got = convert.tables_from_numpy(_leaves(jt), device="cpu")
    for k, v in tt.meng.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got.meng[k], v), k
        else:
            assert got.meng[k] == v and type(got.meng[k]) is type(v), k
    again = convert.tables_from_numpy(convert.tables_to_numpy(tt), device="cpu")
    assert again.meng["width"] == tt.meng["width"] and torch.equal(again.meng["cell_chan"], tt.meng["cell_chan"])
    cfg, tcfg = RenderConfig(**SRGB, texel_format=fmt), TorchConfig(**SRGB, texel_format=fmt)
    js = build_scene(cfg, jt)
    ts = convert.scene_from_numpy(_leaves(js), device="cpu")
    assert ts.texture.dtype == (torch.int32 if fmt == "u32" else torch.float32)
    np.testing.assert_array_equal(ts.texture.numpy(), np.asarray(js.texture).astype(ts.texture.numpy().dtype))
    back = convert.scene_from_numpy(convert.scene_to_numpy(ts), device="cpu")
    assert torch.equal(back.texture, ts.texture) and back.texel_meta is None


def test_train_step_leaves_the_texture_out():
    """The port's train step in meng mode on the CPU: finite loss and
    gradients, and no gradient reaches the texture.  forward_backward_step
    itself runs this mode in the bench's test
    (tests/test_torch_trainstep.py)."""
    tcfg = TorchConfig(**SRGB, observer=2006, texel_format="rows")
    tt = tcol.build_color_tables(tcfg, device="cpu")
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
    assert float(grads["albedo_values"].abs().max()) > 0.0


# (first hero wavelength, hero step, hero wavelengths): CIE 1931 and 2006 at
# 4 wavelengths, and CIE 1931 at 3, whose step is no whole number of bins
HEROES = [(380.0, 100.0, 4), (390.0, 110.0, 4), (380.0, 400.0 / 3.0, 3)]


@pytest.mark.parametrize("lam_lo, step, n_wl", HEROES, ids=["1931-4wl", "2006-4wl", "1931-3wl"])
def test_twin_matches_the_unfactored_evaluation(tables, xyz, lam_lo, step, n_wl):
    """M1's twin on the walk's (point id, weight) rows of seeded XYZ (inner
    cells, boundary fan cells, off the grid, black) against
    ``spectrum_xyz_to_p_soa``, which interpolates the spectra before
    weighting them: the same sum in another order."""
    _, tt = tables
    _, (x, y, z) = xyz
    m = tt.meng
    pidx, w = tmeng.meng_cell_weights_soa(m, _t(x), _t(y), _t(z))
    rows = torch.cat([pidx.T.to(torch.float32), w.T], dim=1).contiguous()
    lam0 = _t((lam_lo + np.random.default_rng(24).uniform(0, 1, len(x)) * step).astype(np.float32))
    want = tmeng.spectrum_xyz_to_p_soa(m, _t(x), _t(y), _t(z), tmeng.hero_lams_soa(lam0, n_wl, step))
    got = tmeng.meng_albedo_hero(m, "rows", rows, lam0, n_wl, step)
    assert got.shape == (n_wl, len(x)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=1e-6 * want.abs().max().item())
    cells = tmeng._uv_position(m, _t(x), _t(y), _t(z))[4].to(torch.int64)
    assert (m["grid_inside"][cells] == 0).any() and (m["grid_inside"][cells] > 0).any()
    assert (got[:, 512:620] == 0.0).float().mean() > 0.5  # off the grid and black give zero


@pytest.mark.parametrize("lam_lo, step, n_wl", HEROES, ids=["1931-4wl", "2006-4wl", "1931-3wl"])
def test_twin_of_words_matches_the_unfactored_evaluation(tables, lam_lo, step, n_wl):
    """The "u32" twin on seeded sRGB words and the extremes (black, white,
    the saturated primaries) against ``spectrum_xyz_to_p_soa`` of the same
    decode and matrix; and the "u32" and "rows" twins equal bit for bit on
    rows the walk made of those words."""
    _, tt = tables
    m = tt.meng
    rng = np.random.default_rng(25)
    words = rng.integers(0, 1 << 24, 4096).astype(np.int32)
    words[:6] = [0x000000, 0xFFFFFF, 0xFF0000, 0x00FF00, 0x0000FF, 0xFFFF00]
    words = _t(words)
    lam0 = _t((lam_lo + rng.uniform(0, 1, len(words)) * step).astype(np.float32))
    lut = tmeng.srgb_decode_table()
    r, g, b = (lut[((words >> s) & 0xFF).to(torch.int64)] for s in (16, 8, 0))
    x, y, z = tmeng.lrgb_to_xyz_meng(r, g, b)
    want = tmeng.spectrum_xyz_to_p_soa(m, x, y, z, tmeng.hero_lams_soa(lam0, n_wl, step))
    got = tmeng.meng_albedo_hero(m, "u32", words, lam0, n_wl, step)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=1e-6 * want.abs().max().item())
    assert (got[:, 0] == 0.0).all()  # black is off the grid
    pidx, w = tmeng.meng_cell_weights_soa(m, x, y, z)
    rows = torch.cat([pidx.T.to(torch.float32), w.T], dim=1).contiguous()
    assert torch.equal(tmeng.meng_albedo_hero(m, "rows", rows, lam0, n_wl, step), got)


def test_decode_table_is_the_plain_decode():
    """The 256-entry table M1 and its twin decode through equals
    ``srgb_to_lrgb`` of each code over 255, and the shading's own texel
    decode of each grey word, exactly."""
    lut = tmeng.srgb_decode_table()
    assert lut.dtype == torch.float32 and lut.shape == (256,)
    assert torch.equal(lut, tcol.srgb_to_lrgb(torch.arange(256, dtype=torch.float32) * (1.0 / 255.0)))
    grey = torch.arange(256, dtype=torch.int32) * 0x010101
    for channel in tshade.texel_fetch_lrgb(None, None, texel_words=grey):
        assert torch.equal(channel, lut)
    assert tmeng.srgb_decode_table() is lut  # built once


def test_wrapper_refuses_what_the_kernel_cannot_read(tables):
    _, tt = tables
    m = tt.meng
    lam0 = torch.full((8,), 500.0)
    words = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="texel format"):
        tmeng.meng_albedo_hero(m, "q32", words, lam0, 4, 100.0)
    with pytest.raises(ValueError, match="lam0"):
        tmeng.meng_albedo_hero(m, "u32", words, lam0.double(), 4, 100.0)
    with pytest.raises(ValueError, match="lam0"):
        tmeng.meng_albedo_hero(m, "u32", words, torch.full((16,), 500.0)[::2], 4, 100.0)
    with pytest.raises(ValueError, match="u32 texels"):
        tmeng.meng_albedo_hero(m, "u32", words.long(), lam0, 4, 100.0)
    with pytest.raises(ValueError, match="rows texels"):
        tmeng.meng_albedo_hero(m, "rows", torch.zeros((8, 11)), lam0, 4, 100.0)
    with pytest.raises(ValueError, match="CUDA"):
        tmeng.meng_albedo_hero_cuda(m, "u32", words, lam0, 4, 100.0)
    assert tmeng.LAUNCHES == 0


def test_port_imports_and_runs_meng_without_nvcc(tmp_path):
    """The package imports, and runs Meng's albedo on the CPU, with no
    ``nvcc`` on the PATH and no JAX: kernels build at first launch only."""
    code = (
        "import sys, torch\n"
        "import simple_spectral_torch\n"
        "from simple_spectral_torch import kernels\n"
        "from simple_spectral_torch.render import shading\n"
        "from simple_spectral_torch.spectra import upsample_meng as um\n"
        "from simple_spectral_torch.spectra.colorimetry import build_color_tables\n"
        "from simple_spectral_torch.config import RenderConfig\n"
        "t = build_color_tables(RenderConfig(mode='meng'), device='cpu')\n"
        "out = um.meng_albedo_hero(t.meng, 'u32', torch.tensor([0x336699, 0], dtype=torch.int32),\n"
        "                          torch.tensor([450.0, 500.0]), 4, 100.0)\n"
        "assert out.shape == (4, 2) and bool((out[:, 0] > 0).all()) and bool((out[:, 1] == 0).all())\n"
        "assert not kernels._loaded and um.LAUNCHES == 0\n"
        "assert 'jax' not in sys.modules\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PATH": os.path.dirname(sys.executable), "PYTHONPATH": root, "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
