"""The port's training step against the JAX package's, on the CPU: cornell-srgb
mallett at 8x8, 2 spp, depth 3 (one JAX compile of ``forward_backward_step``,
remat "none"), the same keys, pixels and targets on both sides.

Tolerance.  ``__graft_entry__.py`` holds two JAX programs to rtol 2e-5 on the
loss and atol 3e-5 on gradients scaled by their largest entry.  The two
packages do not meet that on every key: they trace the same paths, but the
NEE solid angle ``alpha + beta + gamma - pi`` cancels most of its digits and
XLA's acos/sin/cos/rsqrt differ from torch's in the last bits (ROADMAP queue
3), so a lane that sees a light triangle edge-on carries a relative error of
up to ~2e-2 into the loss and the gradients.  Measured over 40 seeds: loss
within 3.31e-5, scaled gradients within 4.25e-3 (albedo_values) and 1.67e-3
(emission_values); the median seed within 5e-6 and 2e-5.  The test runs ten
seeds and holds the worst to rtol 1e-4 on the loss and atol 1e-2 on the
scaled gradients, and the median seed to the ``__graft_entry__.py`` loss
bound and 1e-4 on the gradients.  Tables the mode does not read get zeros on
both sides.

The port-only tests check the options against the plain step (``remat``,
``remat_cache``, ``forward_only_step``), rgb gradients against central
differences, and the shape of ``python -m simple_spectral_torch.bench``'s
JSON line.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import bench as tbench
from simple_spectral_torch import random as trandom
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import trainstep as tts
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render.trainstep import forward_backward_step
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

TINY = dict(width=8, height=8, spp=2, max_depth=3)
SPP = 2
SEEDS = range(10)
WORST_LOSS_RTOL, WORST_GRAD_ATOL = 1e-4, 1e-2
MEDIAN_LOSS_RTOL, MEDIAN_GRAD_ATOL = 2e-5, 1e-4
OPTION_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on one
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(scene_name, mode, **kw):
    tcfg = TorchConfig(**TINY, scene=scene_name, mode=mode, **kw)
    tables = t_build_tables(tcfg, device="cpu")
    return tcfg, t_build_scene(tcfg, tables, device="cpu"), tables


@pytest.fixture(scope="module")
def srgb():
    return _port("cornell-srgb", "mallett")


def _inputs(seed, n_px=64):
    rng = np.random.default_rng(seed)
    return np.arange(n_px, dtype=np.int32), rng.uniform(0.0, 2.0, (n_px, 3)).astype(np.float32)


def _scaled_err(got, want):
    scale = max(float(np.abs(want).max()), 1e-8)
    return float(np.abs(got - want).max()) / scale


def test_loss_and_grads_match_jax(srgb):
    tcfg, ts, tt = srgb
    cfg = RenderConfig(**TINY, scene="cornell-srgb", mode="mallett")
    jt = build_color_tables(cfg)
    js = build_scene(cfg, jt)
    step = jax.jit(forward_backward_step, static_argnums=(2, 6, 7))
    loss_err, grad_err = [], []
    for seed in SEEDS:
        px, target = _inputs(seed)
        lj, gj = step(js, jt, cfg, jax.random.PRNGKey(seed), jnp.asarray(px), jnp.asarray(target), SPP, "none")
        lt, gt = tts.forward_backward_step(ts, tt, tcfg, trandom.PRNGKey(seed), torch.from_numpy(px),
                                           torch.from_numpy(target), SPP)
        assert set(gt) == set(gj) == set(tts.DIFF_FIELDS)
        loss_err.append(abs(float(lt) / float(lj) - 1.0))
        errs = []
        for f in tts.DIFF_FIELDS:
            g, h = np.asarray(gj[f]), gt[f].numpy()
            assert h.shape == g.shape and np.isfinite(h).all(), f
            if f in ("albedo_rgb", "emission_rgb"):  # mallett reads the spectra, not the rgb tables
                assert not h.any() and not g.any(), f
            else:
                assert np.abs(g).max() > 0.0, f
                errs.append(_scaled_err(h, g))
        grad_err.append(max(errs))
    print(f"loss rel errors {np.round(loss_err, 8)}; scaled grad errors {np.round(grad_err, 7)}")
    assert max(loss_err) < WORST_LOSS_RTOL and max(grad_err) < WORST_GRAD_ATOL
    assert np.median(loss_err) < MEDIAN_LOSS_RTOL and np.median(grad_err) < MEDIAN_GRAD_ATOL


def _step(tcfg, ts, tt, seed=3, remat="none"):
    px, target = _inputs(seed)
    return tts.forward_backward_step(ts, tt, tcfg, trandom.PRNGKey(seed), torch.from_numpy(px),
                                     torch.from_numpy(target), SPP, remat=remat)


@pytest.mark.parametrize("remat,remat_cache", [("trace", True), ("none", False), ("trace", False)])
def test_remat_options_give_the_plain_step(srgb, remat, remat_cache):
    tcfg, ts, tt = srgb
    loss0, grads0 = _step(tcfg, ts, tt)
    loss, grads = _step(tcfg.replace(remat_cache=remat_cache), ts, tt, remat=remat)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=OPTION_RTOL)
    for f in tts.DIFF_FIELDS:
        np.testing.assert_allclose(grads[f].numpy(), grads0[f].numpy(), rtol=OPTION_RTOL,
                                   atol=OPTION_RTOL * float(grads0[f].abs().max()), err_msg=f)


def test_forward_only_step_is_the_loss(srgb):
    tcfg, ts, tt = srgb
    loss, _ = _step(tcfg, ts, tt)
    px, target = _inputs(3)
    fwd = tts.forward_only_step(ts, tt, tcfg, trandom.PRNGKey(3), torch.from_numpy(px), torch.from_numpy(target),
                                SPP)
    assert not fwd.requires_grad
    np.testing.assert_allclose(float(fwd), float(loss), rtol=OPTION_RTOL)
    with pytest.raises(ValueError, match="remat"):
        _step(tcfg, ts, tt, remat="all")


def test_rgb_gradient_matches_central_differences():
    """cornell rgb: the loss is a polynomial of the rgb albedos (the paths do
    not depend on them), so central differences with a step of 1e-2 of the
    entry agree with autograd to ~1e-4; held to 1e-3 on the two entries of
    albedo_rgb with the largest gradient."""
    tcfg, ts, tt = _port("cornell", "rgb")
    loss, grads = _step(tcfg, ts, tt)
    g = grads["albedo_rgb"]
    assert not grads["albedo_values"].any() and not grads["emission_values"].any()
    px, target = _inputs(3)
    for flat in torch.argsort(g.abs().reshape(-1), descending=True)[:2].tolist():
        idx = np.unravel_index(flat, tuple(g.shape))
        h = 1e-2 * float(ts.materials.albedo_rgb[idx])
        losses = []
        for sign in (1.0, -1.0):
            table = ts.materials.albedo_rgb.clone()
            table[idx] += sign * h
            shifted = tts.with_material_params(ts, {"albedo_rgb": table})
            losses.append(float(tts.forward_only_step(shifted, tt, tcfg, trandom.PRNGKey(3), torch.from_numpy(px),
                                                      torch.from_numpy(target), SPP)))
        fd = (losses[0] - losses[1]) / (2.0 * h)
        np.testing.assert_allclose(float(g[idx]), fd, rtol=1e-3)


def test_bench_prints_bench_py_json_line_on_the_cpu(capsys):
    rc = tbench.main(["--device", "cpu", "--lanes", "64", "--max-depth", "2", "--rounds", "3", "--calls", "1",
                      "--size", "16"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"metric", "value", "unit", "vs_baseline", "spread", "rounds", "calls_per_round", "lanes_per_call",
            "rays_per_sample_equivalent", "intersects_per_sample_actual", "honest_18_sweep", "configs", "device"}
    assert set(line) == keys
    assert line["device"] == "cpu" and line["lanes_per_call"] == 64 and line["rounds"] == 3
    assert line["rays_per_sample_equivalent"] == 3 and line["intersects_per_sample_actual"] == 2
    assert line["spread"][0] <= line["value"] <= line["spread"][1]
    cfgs = line["configs"]
    assert len(cfgs) == 4 and all(isinstance(v, float) and v > 0 for v in cfgs.values())
    assert "cfg3 cornell-srgb meng 2006 256^2" in cfgs and "cfg4 plane-srgb jakob 512^2" in cfgs


def test_bench_needs_a_card_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tbench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


class BenchRecorder:
    """Stands in for the bench's scene builds and its step: each step call
    records its configuration's mode and observer and its key; a
    configuration in ``raises`` fails its scene build."""

    def __init__(self, monkeypatch, raises=()):
        from types import SimpleNamespace

        from simple_spectral_torch.scene import library
        from simple_spectral_torch.spectra import colorimetry

        self.calls = []

        def build_scene(cfg, tables, device="cuda"):
            if cfg.mode in raises:
                raise MemoryError("out of memory")
            return SimpleNamespace(device=torch.device(device))

        def step(scene, tables, cfg, key, px, target, spp_chunk):
            self.calls.append(((cfg.scene, cfg.mode), key.numpy().copy()))
            return torch.zeros(()), {}

        monkeypatch.setattr(colorimetry, "build_color_tables", lambda cfg, device="cuda": "tables")
        monkeypatch.setattr(library, "build_scene", build_scene)
        monkeypatch.setattr(tts, "forward_backward_step", step)


def test_bench_records_a_failing_config_and_fails_the_run(monkeypatch, capsys):
    BenchRecorder(monkeypatch, raises=("meng",))
    rc = tbench.main(["--device", "cpu", "--rounds", "1", "--calls", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    assert line["value"] > 0 and line["calls_per_round"] == 1
    cfgs = line["configs"]
    assert list(cfgs) == list(tbench.BASELINE_CONFIGS)
    assert cfgs["cfg3 cornell-srgb meng 2006 256^2"].startswith("error: ")
    assert "out of memory" in cfgs["cfg3 cornell-srgb meng 2006 256^2"]
    assert all(isinstance(v, float) and v > 0 for k, v in cfgs.items() if "meng" not in k)


def test_bench_keys_are_bench_py_schedule(monkeypatch, capsys):
    rec = BenchRecorder(monkeypatch)
    rounds, k_calls = 2, 3
    assert tbench.main(["--device", "cpu", "--rounds", str(rounds), "--calls", str(k_calls)]) == 0
    key = jax.random.PRNGKey(0)

    def bench_py_keys(round_key):
        # bench.py:64-71 after a finite loss, timeit_chained's warm-ups i = 0, 1 first
        return [np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.fold_in(round_key, i), 0)))
                for i in [*range(tbench.WARMUP_CALLS), *range(k_calls)]]

    want = [(("cornell-srgb", "mallett"), k) for r in range(rounds) for k in bench_py_keys(jax.random.fold_in(key, r))]
    for ci, kw in enumerate(tbench.BASELINE_CONFIGS.values()):
        want += [((kw["scene"], kw["mode"]), k) for r in range(rounds)
                 for k in bench_py_keys(jax.random.fold_in(key, 100 + 10 * ci + r))]  # bench.py:157
    assert [c for c, _ in rec.calls] == [c for c, _ in want]
    for (_, got), (_, k) in zip(rec.calls, want):
        np.testing.assert_array_equal(got, k.astype(np.int64))
