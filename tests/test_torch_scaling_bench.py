"""The port's scaling bench (``simple_spectral_torch/tools/scaling_bench.py``)
against the JAX tool it replaces (``tools/scaling_bench.py``), on the CPU.

No JAX compile of the render: ``tests/test_torch_parallel_grad.py`` already
holds the sharded step against the JAX package's.  Here:

* the timed step's schedule equals the JAX tool's bit for bit, built with
  eager ``jax.random`` and ``jnp``: pixels, target and the keys of calls
  0-3 (the JAX tool's chain token is 0 for a finite loss);
* the ray accounting is ``tools/scaling_bench.py:71``'s;
* the step the bench times on a mesh of two CPU entries gives the loss and
  gradients of ``emulated_loss_and_grad`` within the dry run's bound (loss
  rtol 2e-5, scaled gradients atol 3e-5), as in
  ``tests/test_torch_parallel_grad.py``;
* the JSON of ``--equal-work`` and of weak scaling has the JAX tool's keys
  and its formulas, and ``--worlds 1,2`` through gloo writes one row per
  world;
* without a card, or asked for more cards than are present, it exits
  non-zero.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.convert import DIFF_FIELDS
from simple_spectral_torch.parallel import dryrun
from simple_spectral_torch.parallel.sharding import emulated_loss_and_grad, make_mesh
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables
from simple_spectral_torch.tools import scaling_bench as sb

SMALL = ["--lanes-per-dev", "16", "--spp", "1", "--size", "8", "--max-depth", "3", "--device", "cpu"]
# the JAX tool's JSON keys (tools/scaling_bench.py:111-116 and :134-137)
JAX_EQUAL_KEYS = {"backend", "device", "protocol", "total_lanes", "spp", "sharded_over_single", "results"}
JAX_WEAK_KEYS = {"backend", "device", "lanes_per_dev", "spp", "results"}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the worlds' processes
    yield
    torch.set_num_threads(n)


def _jax_step_inputs(cfg, lanes):
    """tools/scaling_bench.py:57-59."""
    px = jnp.arange(lanes, dtype=jnp.int32) % (cfg.width * cfg.height)
    return px, jnp.zeros((lanes, 3), jnp.float32)


@pytest.mark.parametrize("size, lanes", [(512, 8192), (8, 200)], ids=["512^2", "8^2-wrapping"])
def test_schedule_matches_the_jax_tool(size, lanes):
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=size, height=size, spp=64)
    px, target = sb.step_inputs(cfg, lanes, "cpu")
    jpx, jtarget = _jax_step_inputs(cfg, lanes)
    assert px.dtype == torch.int32 and target.dtype == torch.float32
    np.testing.assert_array_equal(px.numpy(), np.asarray(jpx))
    np.testing.assert_array_equal(target.numpy(), np.asarray(jtarget))
    key = jax.random.PRNGKey(0)
    for i in range(4):
        # tools/scaling_bench.py:66-69 after a call whose loss was finite
        tok = (jnp.float32(0.731) * 1e-30).astype(jnp.int32)
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.fold_in(key, i), tok)))
        np.testing.assert_array_equal(sb.call_key(i).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("depth", [3, 10])
def test_ray_accounting_is_the_jax_tools(depth):
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=512, height=512, spp=64, max_depth=depth)
    lanes, spp = 4096 * 4, 4
    assert sb.rays_per_call(cfg, lanes, spp) == float(lanes) * spp * (2 * cfg.max_depth - 1)  # :71
    assert sb.rays_per_call(cfg, 1, 1) == {3: 5, 10: 19}[depth]


def test_timed_step_is_the_emulated_step():
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=64, max_depth=3)
    tables = build_color_tables(cfg, device="cpu")
    scene = build_scene(cfg, tables, device="cpu")
    mesh = make_mesh(["cpu"] * 2, dp=2, sp=1)
    loss, grads = sb.timed_step(cfg, scene, tables, mesh, 16, 1)(1)
    px, target = sb.step_inputs(cfg, 32, "cpu")
    loss1, grads1 = emulated_loss_and_grad(scene, tables, cfg, 2, 1, sb.call_key(1), px, target, 1)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=dryrun.LOSS_RTOL)
    for f in DIFF_FIELDS:
        g, g1 = grads[f].numpy(), grads1[f].numpy()
        assert np.abs(g - g1).max() / max(np.abs(g1).max(), 1e-8) <= dryrun.GRAD_ATOL, f
    assert float(loss) > 0.0 and grads["emission_values"].abs().max() > 0.0


@pytest.mark.parametrize("mode", ["equal-work", "weak"])
def test_json_has_the_jax_tools_keys(tmp_path, mode):
    out = tmp_path / "scaling.json"
    assert sb.main([str(out), "--repeat", "2", *SMALL, *(["--equal-work"] if mode == "equal-work" else [])]) == 0
    got = json.loads(out.read_text())
    assert set(got) == (JAX_EQUAL_KEYS if mode == "equal-work" else JAX_WEAK_KEYS)
    assert got["backend"] == "cpu" and got["spp"] == 1
    rows = got["results"]
    assert [r["devices"] for r in rows] == [1, 2] and all(r["processes"] == 1 for r in rows)
    assert all(r["k1_launches_per_call"] == 0 for r in rows)  # the CPU runs K1's twin
    m1, m2 = (r["mrays_per_s"] for r in rows)
    if mode == "equal-work":
        assert got["total_lanes"] == 32 and [r["lanes"] for r in rows] == [32, 32]
        assert got["sharded_over_single"] == m2 / m1  # :115
    else:
        assert got["lanes_per_dev"] == 16
        assert [r["efficiency"] for r in rows] == [1.0, m2 / (2 * m1)]  # :128


def test_worlds_through_gloo_write_one_row_each(tmp_path):
    out = tmp_path / "worlds.json"
    assert sb.main([str(out), "--worlds", "1,2", *SMALL]) == 0
    got = json.loads(out.read_text())
    assert JAX_WEAK_KEYS <= set(got) and got["protocol"] == "one process per card"
    rows = got["results"]
    assert [(r["processes"], r["devices"]) for r in rows] == [(1, 1), (2, 2)]
    assert [r["efficiency"] for r in rows] == [1.0, rows[1]["mrays_per_s"] / (2 * rows[0]["mrays_per_s"])]
    assert all(r["mrays_per_s"] > 0.0 for r in rows)


def test_no_card_and_too_few_cards_exit_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sb.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    # one card present, a world of two asked for: refused before any process starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sb.main(["--worlds", "1,2"]) == 1
    assert "a world of 2 processes needs as many cards, 1 present" in capsys.readouterr().err
