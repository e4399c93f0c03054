"""The port's progressive renderer and its CLI against the JAX package's, on
the CPU.

One configuration and one pass size serve every test that renders in JAX
(cornell, rgb, 8x8, 8 spp in passes of 4, depth 3), so that one compile of
the JAX package's ``_render_chunk`` serves them all: its CLI builds the
same ``RenderConfig`` from the same flags.  Images are held within the flip
bound of tests/test_parallel.py (XLA on the CPU contracts ``a*b + c`` and
differs from torch in transcendentals, which can flip a grazing hit): at most
4 of 64 pixels off by rel >= 1e-3, each within rel < 0.5, means to 2e-3.
"""

import json

import numpy as np
import pytest

from simple_spectral_torch.cli import main
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import progressive as tprog
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_torch.utils.native_fb import load_native
from simple_spectral_tpu.cli import main as j_main
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render import progressive as jprog
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

KW = dict(scene="cornell", mode="rgb", width=8, height=8, spp=8, max_depth=3)
PASS_SPP = 4
ARGV = ["-s", "cornell", "--mode", "rgb", "-w", "8", "-h", "8", "-spp", "8", "--max-depth", "3",
        "--pass-spp", str(PASS_SPP), "--quiet"]


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = RenderConfig(**KW), TorchConfig(**KW)
    jt = build_color_tables(cfg)
    tt = t_build_tables(tcfg, device="cpu")
    return cfg, build_scene(cfg, jt), jt, tcfg, t_build_scene(tcfg, tt, device="cpu"), tt


def _port(setup, **kw):
    _, _, _, tcfg, ts, tt = setup
    return tprog.ProgressiveRenderer(tcfg, ts, tt, spp_per_pass=PASS_SPP, **kw)


def _jax(setup, **kw):
    cfg, js, jt = setup[:3]
    return jprog.ProgressiveRenderer(cfg, js, jt, spp_per_pass=PASS_SPP, **kw)


def _assert_flip_bound(v_got, v_ref):
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)


def _read_pfm(path):
    with open(path, "rb") as f:
        assert f.readline() == b"PF\n"
        w, h = map(int, f.readline().split())
        assert float(f.readline()) < 0  # little-endian
        return np.frombuffer(f.read(), "<f4").reshape(h, w, 3)


@pytest.mark.parametrize("kw", [KW, dict(scene="cornell-srgb", mode="meng", observer=2006, spp=3),
                                dict(scene="cornell-stress", intersect_impl="bvh", debug_checks=True)],
                         ids=["cornell-rgb", "srgb-meng", "stress-bvh"])
def test_fingerprint_equals_jax(kw):
    assert tprog._cfg_fingerprint(TorchConfig(**kw)) == jprog._cfg_fingerprint(RenderConfig(**kw))


def test_progressive_mean_matches_jax(setup):
    """The same passes draw the same sample streams in both packages (keys
    from (seed, samples done, chunk)), so the means agree within the flip
    bound; the alpha, a pure hit count, exactly."""
    a, b = _jax(setup, seed=5, native=False), _port(setup, seed=5, native=False)
    a.run()
    b.run()
    (va, aa), (vb, ab) = a.mean_value(), b.mean_value()
    assert a.spp_done == b.spp_done == 8 and b.metrics.to_dict()["n_passes"] == 2
    _assert_flip_bound(vb, va)
    np.testing.assert_array_equal(ab, aa)


def test_cli_matches_jax_and_writes_its_metrics(tmp_path, capsys):
    """``main`` of each package on the same flags: .pfm images within the
    flip bound and --metrics-json lines with the same keys and counts."""
    lines = []
    for name, fn in (("jax", j_main), ("torch", main)):
        extra = ["--device", "cpu"] if name == "torch" else []
        assert fn(ARGV + ["-o", str(tmp_path / f"{name}.pfm"), "--metrics-json", "-"] + extra) == 0
        lines.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    j, t = lines
    assert t.keys() == j.keys()
    for k in ("scene", "mode", "observer", "resolution", "spp", "max_depth", "els", "rays_traced", "n_passes"):
        assert t[k] == j[k], k
    _assert_flip_bound(_read_pfm(tmp_path / "torch.pfm"), _read_pfm(tmp_path / "jax.pfm"))


def test_cli_checkpoint_resumes(setup, tmp_path, capsys):
    """A checkpoint of one pass, written by the renderer, is resumed by the
    CLI, whose image then equals an uninterrupted CLI render bit for bit."""
    whole, resumed, ckpt = tmp_path / "whole.pfm", tmp_path / "resumed.pfm", str(tmp_path / "r.ckpt")
    assert main(ARGV + ["-o", str(whole), "--device", "cpu"]) == 0
    first = _port(setup, seed=0, checkpoint_path=ckpt)
    first.run_pass()
    first.save_checkpoint()
    capsys.readouterr()
    assert main(ARGV + ["-o", str(resumed), "--checkpoint", ckpt, "--device", "cpu"]) == 0
    assert f"resumed from {ckpt} at {PASS_SPP} spp" in capsys.readouterr().err
    assert open(whole, "rb").read() == open(resumed, "rb").read()


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_checkpoints_cross_packages(setup, tmp_path, native):
    """A checkpoint written by the JAX renderer resumes in the port and the
    reverse, in both backends: the same fingerprint, sidecar and .npz
    layout, and the same C++ source for the native file."""
    if native and load_native() is None:
        pytest.skip("no C++ compiler")
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    j = _jax(setup, seed=2, checkpoint_path=j_path, native=native)
    j.run_pass()
    j.save_checkpoint()
    t = _port(setup, seed=2, checkpoint_path=j_path, native=native)
    assert t.native == native and t.resume() and t.spp_done == PASS_SPP
    for got, want in zip(t.mean_value(), j.mean_value()):
        np.testing.assert_array_equal(got, want)

    t.save_checkpoint(t_path)
    j2 = _jax(setup, seed=2, checkpoint_path=t_path, native=native)
    assert j2.resume() and j2.spp_done == PASS_SPP
    for got, want in zip(j2.mean_value(), t.mean_value()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_resume_is_bitwise_and_checks_the_checkpoint(setup, tmp_path, native):
    """Interrupted after one pass and resumed by a fresh renderer equals the
    uninterrupted render bit for bit; a checkpoint of another sample target,
    seed or version is refused, as in the JAX package."""
    if native and load_native() is None:
        pytest.skip("no C++ compiler")
    ckpt = str(tmp_path / "r.ckpt")
    whole = _port(setup, seed=9, native=native)
    whole.run()
    first = _port(setup, seed=9, checkpoint_path=ckpt, native=native)
    first.run_pass()
    first.save_checkpoint()
    second = _port(setup, seed=9, checkpoint_path=ckpt, native=native)
    assert second.resume() and second.spp_done == PASS_SPP
    second.run()
    for got, want in zip(second.mean_value(), whole.mean_value()):
        assert np.array_equal(got, want), np.abs(got - want).max()

    _, _, _, tcfg, ts, tt = setup
    with pytest.raises(ValueError, match="different RenderConfig"):
        tprog.ProgressiveRenderer(tcfg.replace(spp=16), ts, tt, seed=9, checkpoint_path=ckpt, native=native).resume()
    with pytest.raises(ValueError, match="seed"):
        _port(setup, seed=8, checkpoint_path=ckpt, native=native).resume()
    if not native:
        z = dict(np.load(ckpt))
        with open(ckpt, "wb") as f:
            np.savez(f, **dict(z, version=2))
        with pytest.raises(ValueError, match="version"):
            _port(setup, seed=9, checkpoint_path=ckpt, native=native).resume()
    assert not _port(setup, seed=9, checkpoint_path=str(tmp_path / "none")).resume()


def test_native_equals_numpy_and_its_tonemap(setup):
    """Both backends give the same mean bit for bit; the native u8 tonemap
    agrees with the quantized ``image`` within 1 LSB."""
    if load_native() is None:
        pytest.skip("no C++ compiler")
    a, b = _port(setup, seed=3, native=True), _port(setup, seed=3, native=False)
    assert a.native and not b.native
    a.run()
    b.run()
    for got, want in zip(a.mean_value(), b.mean_value()):
        assert np.array_equal(got, want)
    ua, ub = a.image_u8().astype(int), b.image_u8().astype(int)
    assert ua.shape == (8, 8, 4) and np.abs(ua - ub).max() <= 1


def test_native_accumulator_falls_back_to_numpy(setup, monkeypatch, tmp_path):
    """Without a buildable library ``native=None`` accumulates in numpy and
    ``native=True`` raises with the reason."""
    from simple_spectral_torch.utils import native_fb

    monkeypatch.setattr(native_fb, "_lib", None)
    monkeypatch.setattr(native_fb, "_error", None)
    monkeypatch.setattr(native_fb, "SOURCE", str(tmp_path / "missing.cpp"))
    assert not _port(setup).native
    with pytest.raises(RuntimeError, match="no native source"):
        _port(setup, native=True)


def test_entry_points_default_to_the_card(setup, monkeypatch):
    """Without a card the renderer refuses to build on its default device,
    and the default mesh (every local card) refuses too."""
    import torch

    from simple_spectral_torch.parallel import make_mesh

    tcfg = setup[3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprog.ProgressiveRenderer(tcfg)
