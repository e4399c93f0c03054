"""The port's public helpers, metrics, profiling hooks and live preview, on
the CPU.  Each helper is held against its JAX function on tiny arrays (no
render compile; each JAX function is jitted, one small compile, rather than
run op by op); the preview tests follow tests/test_preview.py on the port
alone (HTTP on an ephemeral port, ANSI into a buffer)."""

import io
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_spectral_torch
from simple_spectral_torch import io as tio, render as trender, scene as tscene, spectra as tspectra
from simple_spectral_torch import utils as tutils
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.io.image import load_png_rgb
from simple_spectral_torch.io.preview import AnsiPreview, HttpPreview, open_preview
from simple_spectral_torch.spectra import colorimetry as tcol
from simple_spectral_torch.spectra import spectrum as tspec
from simple_spectral_tpu import io as jio, render as jrender, scene as jscene, spectra as jspectra
from simple_spectral_tpu import utils as jutils
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render.intersect import intersect_rays as j_intersect_rays
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra import colorimetry as jcol
from simple_spectral_tpu.spectra import spectrum as jspec

RNG = np.random.default_rng(17)
VALUES = RNG.uniform(0.0, 2.0, 9).astype(np.float32)
LAM = RNG.uniform(370.0, 800.0, (3, 5)).astype(np.float32)  # some outside [380, 780]


@pytest.fixture(scope="module")
def mallett():
    cfg, tcfg = RenderConfig(mode="mallett"), TorchConfig(mode="mallett")
    return jcol.build_color_tables(cfg), tcol.build_color_tables(tcfg, device="cpu")


def test_package_exports_match_the_jax_package():
    """Every package's export list is the JAX package's (``parallel`` is
    queue 1 item 14); the top level adds ``resolve_device``."""
    for ours, theirs in ((trender, jrender), (tspectra, jspectra), (tscene, jscene), (tutils, jutils),
                         (tio, jio)):
        assert ours.__all__ == theirs.__all__
        assert all(hasattr(ours, name) for name in ours.__all__)
    assert simple_spectral_torch.__all__ == ["RenderConfig", "__version__", "resolve_device"]


def test_sampling_helpers_match_jax():
    t_lam = torch.from_numpy(LAM)
    want = jax.jit(jspec.sample_nearest, static_argnums=(1, 2))(jnp.asarray(VALUES), 380.0, 0.02, jnp.asarray(LAM))
    np.testing.assert_array_equal(tspec.sample_nearest(torch.from_numpy(VALUES), 380.0, 0.02, t_lam).numpy(), want)
    lam0 = LAM[0]
    np.testing.assert_array_equal(tspec.hero_wavelengths(torch.from_numpy(lam0), 4, 100.0).numpy(),
                                  jax.jit(jspec.hero_wavelengths, static_argnums=(1, 2))(jnp.asarray(lam0), 4, 100.0))
    jt = jspec.SpectrumTable(jnp.asarray(VALUES), 380.0, 0.02)
    tt = tspec.SpectrumTable(torch.from_numpy(VALUES), 380.0, 0.02)
    np.testing.assert_allclose(tspec.sample_hero(tt, torch.from_numpy(lam0), 4, 100.0).numpy(),
                               jax.jit(jspec.sample_hero, static_argnums=(2, 3))(jt, jnp.asarray(lam0), 4, 100.0),
                               rtol=1e-6, atol=1e-7)
    # per-item spectra, each on its own range
    vals = RNG.uniform(0.0, 1.0, (3, 7)).astype(np.float32)
    low = np.array([380.0, 400.0, 300.0], np.float32)
    inv = np.array([0.02, 0.0333, 0.0125], np.float32)
    lam = LAM[:, 0]
    got = tspec.sample_hero_batched(*(torch.from_numpy(a) for a in (vals, low, inv, lam)), 4, 100.0)
    want = jax.jit(jspec.sample_hero_batched, static_argnums=(4, 5))(*(jnp.asarray(a) for a in (vals, low, inv, lam)),
                                                                     4, 100.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_colorimetry_helpers_match_jax(mallett):
    jt, tt = mallett
    lrgb = RNG.uniform(0.0, 1.0, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(tcol.round_trip_lrgb(tt, torch.from_numpy(lrgb)).numpy(),
                               jax.jit(jcol.round_trip_lrgb)(jt, jnp.asarray(lrgb)), rtol=1e-5, atol=1e-6)
    flux = RNG.uniform(0.0, 3.0, (6, 4)).astype(np.float32)
    lam0 = RNG.uniform(380.0, 480.0, 6).astype(np.float32)
    np.testing.assert_allclose(
        tcol.specradflux_to_ciexyz_hero(tt, torch.from_numpy(flux), torch.from_numpy(lam0), 4, 100.0).numpy(),
        jax.jit(jcol.specradflux_to_ciexyz_hero, static_argnums=(3, 4))(jt, jnp.asarray(flux), jnp.asarray(lam0), 4,
                                                                        100.0), rtol=1e-5, atol=1e-6)
    d65 = tt.host["d65_rad"]
    np.testing.assert_array_equal(tcol.specradflux_to_ciexyz_host(tt, d65),
                                  jcol.specradflux_to_ciexyz_host(jt, jt.host["d65_rad"]))
    with pytest.raises(ValueError, match="mallett"):
        tcol.round_trip_lrgb(tcol.build_color_tables(TorchConfig(mode="rgb"), device="cpu"), torch.ones(3))


def test_intersect_rays_matches_jax():
    """The row-vector entry on cornell-srgb, the exact dense route against
    the JAX package's exact dense sweep: equal winners, distances within
    1e-5 relative (XLA contracts ``a*b + c``; no ray grazes an edge here)."""
    cfg, tcfg = RenderConfig(scene="cornell-srgb", mode="rgb"), TorchConfig(scene="cornell-srgb", mode="rgb")
    js = build_scene(cfg, jcol.build_color_tables(cfg))
    ts = tscene.build_scene(tcfg, tcol.build_color_tables(tcfg, device="cpu"), device="cpu")
    o = RNG.uniform(60.0, 500.0, (64, 3)).astype(np.float32)
    d = RNG.normal(size=(64, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ignore = np.full(64, -1, np.int32)
    want = jax.jit(j_intersect_rays, static_argnums=4)(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ignore), 1e-3)
    got = trender.intersect_rays(ts, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(ignore), 1e-3)
    for name in ("hit", "prim", "mat"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    hit = np.asarray(want.hit)
    assert hit.sum() > 32
    np.testing.assert_allclose(got.dist.numpy()[hit], np.asarray(want.dist)[hit], rtol=1e-5)


def test_metrics_match_jax_and_timers_run():
    kw = dict(scene="cornell", mode="rgb", width=8, height=8, spp=8, max_depth=3)
    ours, theirs = tutils.RenderMetrics(TorchConfig(**kw)), jutils.RenderMetrics(RenderConfig(**kw))
    for m in (ours, theirs):
        m.record_pass(4, 0.123456789)
        m.record_pass(4, 0.25)
    assert ours.to_dict() == theirs.to_dict() and ours.to_json() == theirs.to_json()
    assert tutils.rays_per_sample(TorchConfig(els=False, max_depth=7)) == 7

    result, best = tutils.timed_call(torch.mm, torch.ones(4, 4), torch.ones(4, 4), reps=2)
    assert torch.equal(result, torch.full((4, 4), 4.0)) and best >= 0.0
    with tutils.Timer() as t:
        x = torch.ones(8) * 2
    assert t.elapsed >= 0.0 and t.stop({"x": (x,)}) >= t.elapsed


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tutils.device_trace(str(tmp_path)) as prof:
        torch.ones(16).cumsum(0)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"] and prof.key_averages()


def _frame(h=8, w=6):
    return np.random.default_rng(0).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def test_http_preview_roundtrip(tmp_path):
    pv = HttpPreview(port=0, quiet=True)
    try:
        base = f"http://127.0.0.1:{pv.port}"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/frame.png", timeout=10)
        frame = _frame()
        pv.update(frame, spp_done=4, spp_total=64)
        png = tmp_path / "f.png"
        png.write_bytes(urllib.request.urlopen(f"{base}/frame.png", timeout=10).read())
        np.testing.assert_array_equal(load_png_rgb(str(png)), frame)
        st = json.loads(urllib.request.urlopen(f"{base}/status.json", timeout=10).read())
        assert st == {"spp_done": 4, "spp_total": 64, "frame_id": 1}
        page = urllib.request.urlopen(f"{base}/", timeout=10).read().decode()
        assert "frame.png" in page and "status.json" in page
        pv.update(np.zeros((4, 4, 4), np.uint8), 8, 64)
        st = json.loads(urllib.request.urlopen(f"{base}/status.json", timeout=10).read())
        assert st["frame_id"] == 2 and st["spp_done"] == 8
    finally:
        pv.close()


def test_ansi_preview_and_kinds():
    buf = io.StringIO()
    pv = AnsiPreview(max_cols=6, max_rows=4, out=buf)
    pv.update(_frame(8, 6), spp_done=3, spp_total=9)
    out = buf.getvalue()
    assert "▀" in out and "\x1b[38;2;" in out and "\x1b[48;2;" in out and "3 / 9 spp" in out
    assert out.count("▀") == 4 * 6  # 8 pixel rows -> 4 text rows
    pv.update(_frame(8, 6))
    assert "\x1b[5A" in buf.getvalue()  # the second frame redraws in place
    pv = open_preview("http", port=0, quiet=True)
    assert isinstance(pv, HttpPreview)
    pv.close()
    with pytest.raises(ValueError):
        open_preview("glfw")
