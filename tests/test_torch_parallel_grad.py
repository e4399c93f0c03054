"""The port's sharded training step (``parallel/sharding.py``
``sharded_loss_and_grad``) against the JAX package's, and against its own
single-device emulation, on the CPU: cornell-srgb, mallett, 8x8, spp 4,
depth 3 (one JAX compile of the step on the 4x2 mesh).

Tolerances.  Against JAX: tests/test_torch_trainstep.py's worst-seed bound
for the two packages (loss rtol 1e-4, gradients scaled by their largest
entry atol 1e-2): they trace the same paths, but XLA's transcendentals
differ from torch's in the last bits.  Sharded against emulated, both the
port's: the dry run's bound (loss rtol 2e-5, scaled gradients atol 3e-5),
the same arithmetic summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.convert import DIFF_FIELDS
from simple_spectral_torch.parallel import dryrun
from simple_spectral_torch.parallel import sharding as tsh
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.parallel import sharding as jsh
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

KW = dict(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=4, max_depth=3)
JAX_LOSS_RTOL, JAX_GRAD_ATOL = 1e-4, 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    tcfg = TorchConfig(**KW)
    tt = t_build_tables(tcfg, device="cpu")
    return tcfg, t_build_scene(tcfg, tt, device="cpu"), tt


def _inputs(seed=3):
    target = np.random.default_rng(seed).uniform(0.0, 2.0, (64, 3)).astype(np.float32)
    return np.arange(64, dtype=np.int32), target


def _scaled_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-8)


def test_sharded_loss_and_grad_matches_jax(port):
    tcfg, ts, tt = port
    cfg = RenderConfig(**KW)
    jt = build_color_tables(cfg)
    js = build_scene(cfg, jt)
    px, target = _inputs()
    mesh = jsh.make_mesh(sp=2)
    lj, gj = jax.jit(lambda: jsh.sharded_loss_and_grad(js, jt, cfg, mesh, jax.random.PRNGKey(3), jnp.asarray(px),
                                                       jnp.asarray(target), cfg.spp))()
    lt, gt = tsh.sharded_loss_and_grad(ts, tt, tcfg, tsh.make_mesh(["cpu"] * 8, sp=2), rnd.PRNGKey(3),
                                       torch.from_numpy(px), torch.from_numpy(target), tcfg.spp)
    assert lt.shape == () and set(gt) == set(gj) == set(DIFF_FIELDS)
    assert abs(float(lt) / float(lj) - 1.0) < JAX_LOSS_RTOL
    for f in DIFF_FIELDS:
        g, h = np.asarray(gj[f]), gt[f].numpy()
        assert h.shape == g.shape and np.isfinite(h).all(), f
        if f in ("albedo_rgb", "emission_rgb"):  # mallett reads the spectra, not the rgb tables
            assert not h.any() and not g.any(), f
        else:
            assert np.abs(g).max() > 0.0, f
            assert _scaled_err(h, g) < JAX_GRAD_ATOL, f


@pytest.mark.parametrize("dp,sp", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_sharded_equals_emulated(port, dp, sp):
    tcfg, ts, tt = port
    px, target = (torch.from_numpy(a) for a in _inputs(5))
    mesh = tsh.make_mesh(["cpu"] * (dp * sp), sp=sp)
    loss, grads = tsh.sharded_loss_and_grad(ts, tt, tcfg, mesh, rnd.PRNGKey(5), px, target, tcfg.spp)
    loss1, grads1 = tsh.emulated_loss_and_grad(ts, tt, tcfg, dp, sp, rnd.PRNGKey(5), px, target, tcfg.spp)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=dryrun.LOSS_RTOL)
    for f in DIFF_FIELDS:
        assert _scaled_err(grads[f].numpy(), grads1[f].numpy()) <= dryrun.GRAD_ATOL, f
    assert grads["emission_values"].abs().max() > 0.0


def test_dryrun_multichip_on_the_cpu(capsys):
    out = dryrun.dryrun_multichip(8, device="cpu")
    assert out["mesh"] == {"dp": 4, "sp": 2} and out["loss"] > 0.0
    assert out["worst_grad_dev"] <= dryrun.GRAD_ATOL
    assert "matches the single-device emulation" in capsys.readouterr().out
