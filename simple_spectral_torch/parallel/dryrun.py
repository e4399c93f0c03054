"""Dry run of the sharded training step on an n-device mesh (the port's
counterpart of ``__graft_entry__.dryrun_multichip``).

One sharded forward+backward step at tiny shapes (cornell-srgb, mallett,
8x8, depth 3, spp 2 sp) on n virtual devices of one kind, with sp = 2 when
n is even, and the loss and every gradient leaf held against the
single-device emulation of the same program (``emulated_loss_and_grad``:
the same per-shard streams, the same reduction structure) to f32
reduction-order tolerance: loss rtol 2e-5, gradients scaled by their
largest entry atol 3e-5.

    python -m simple_spectral_torch.parallel.dryrun 8               # 8 shards on one card
    python -m simple_spectral_torch.parallel.dryrun 8 --device cpu  # on the CPU
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

LOSS_RTOL, GRAD_ATOL = 2e-5, 3e-5


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the step on ``[device] * n_devices`` and assert it against the
    emulation.  Returns the loss, the mesh shape and the worst scaled
    gradient difference."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch import resolve_device
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.parallel.sharding import emulated_loss_and_grad, make_mesh, sharded_loss_and_grad
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    device = resolve_device(device)
    sp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh([device] * n_devices, sp=sp)
    dp = mesh.shape["dp"]
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=2 * sp, max_depth=3)
    tables = build_color_tables(cfg, device=device)
    scene = build_scene(cfg, tables, device=device)
    n_px = cfg.width * cfg.height
    px = torch.arange(n_px, dtype=torch.int32, device=device)
    target = torch.zeros((n_px, 3), dtype=torch.float32, device=device)
    key = rnd.PRNGKey(0)

    loss, grads = sharded_loss_and_grad(scene, tables, cfg, mesh, key, px, target, cfg.spp)
    loss = float(loss)
    assert np.isfinite(loss) and loss > 0.0, loss
    loss1, grads1 = emulated_loss_and_grad(scene, tables, cfg, dp, sp, key, px, target, cfg.spp)
    np.testing.assert_allclose(loss, float(loss1), rtol=LOSS_RTOL)
    worst = 0.0
    for f in grads:
        g, g1 = grads[f].cpu().numpy(), grads1[f].cpu().numpy()
        assert np.isfinite(g).all(), f
        scale = max(np.abs(g1).max(), 1e-8)
        np.testing.assert_allclose(g / scale, g1 / scale, atol=GRAD_ATOL, err_msg=f)
        worst = max(worst, float(np.abs(g - g1).max() / scale))
    assert np.abs(grads["emission_values"].cpu().numpy()).max() > 0.0
    print(f"dryrun_multichip({n_devices}) on {device}: mesh={mesh.shape} loss={loss:.6g} matches the "
          f"single-device emulation (worst scaled grad dev {worst:.2e}) OK")
    return {"loss": loss, "mesh": mesh.shape, "worst_grad_dev": worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--device", default="cuda", help="device repeated n times: cuda (default) or cpu")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
