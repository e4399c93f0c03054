"""The plain reference against the program on the CPU at 8x8 pixels and
depth 3, for both configurations: the train step's loss and gradients,
and a progressive pass's per-pixel sums.  On the CPU the program's closest
hit is K1's plain twin, so the two agree bit for bit."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import common, harness  # noqa: E402
from benchmark.entries import progressive_render, train_step  # noqa: E402

SHRINK = {"width": 8, "height": 8, "max_depth": 3}
CELLS = {"mallett": "mallett-train-2m", "jakob": "jakob-render-64spp"}


def ctx_of(workload, seed=2147483777):
    return harness.context(workload, seed, 0.0, False, device="cpu", shrink=SHRINK)


@pytest.mark.parametrize("mode", sorted(CELLS))
def test_train_step_matches(mode):
    from simple_spectral_torch.render.trainstep import forward_backward_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    ctx = ctx_of(CELLS[mode])
    ctx.traffic = dict(ctx.traffic, spp=1)
    cfg = common.program_config(ctx)
    tables = build_color_tables(cfg, device="cpu")
    scene = build_scene(cfg, tables, device="cpu")
    px, target = common.train_inputs(ctx.seed, 8, 8, 128, "cpu")
    prog = [forward_backward_step(scene, tables, cfg, common.step_key(ctx.seed, i), px, target, 1) for i in (0, 5)]
    ref = train_step.reference_outputs(ctx, px, target, [0, 5])
    for (pl, pg), (rl, rg) in zip(prog, ref):
        assert float(pl) == float(rl)
        for f in pg:
            assert torch.equal(pg[f], rg[f]), f
    assert common.train_gaps([(float(pl), pg) for pl, pg in prog], ref) == (0.0, 0.0)


@pytest.mark.parametrize("mode", sorted(CELLS))
def test_pass_sums_match(mode):
    from simple_spectral_torch.render.progressive import ProgressiveRenderer

    ctx = ctx_of(CELLS[mode])
    cfg = common.program_config(ctx, spp=8)
    pr = ProgressiveRenderer(cfg, seed=12345, spp_per_pass=4, native=False, device="cpu")
    pr.run_pass()
    pr.run_pass()
    ctx.traffic = dict(ctx.traffic, image_spp=8, pass_spp=4)
    ref = progressive_render.reference_means(ctx, 12345, 8, torch.device("cpu"))
    assert np.array_equal(pr.mean_value()[0].reshape(-1, 3), ref)


@pytest.mark.parametrize("mode", sorted(CELLS))
def test_reference_tables_and_scene_match(mode):
    """The reference rebuilds the program's derived state from the data
    files alone: colour tables, material tables, triangles, texel words."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    ctx = ctx_of(CELLS[mode])
    cfg = common.program_config(ctx)
    tables = build_color_tables(cfg, device="cpu")
    scene = build_scene(cfg, tables, device="cpu")
    _, rtables, rscene = common.reference_state(ctx, "cpu")
    for f in ("obs_values", "d65_values", "matr_lrgb_to_xyz", "matr_xyz_to_lrgb"):
        assert torch.equal(getattr(tables, f), getattr(rtables, f)), f
    for f in ("tri_verts", "tri_st", "tri_normal", "tri_prim", "tri_mat", "light_tris", "texture"):
        assert torch.equal(getattr(scene, f), getattr(rscene, f)), f
    for f in ("albedo_values", "emission_values", "albedo_rgb", "emission_rgb", "bsdf_type"):
        assert torch.equal(getattr(scene.materials, f), getattr(rscene.materials, f)), f


def test_bfloat16_shading_differs():
    """The control's lower precision reaches the outputs (the control's
    reading itself is held in test_bench_checks.py)."""
    ctx = ctx_of("mallett-train-2m")
    px, target = common.train_inputs(ctx.seed, 8, 8, 64, "cpu")
    (rl, _), = train_step.reference_outputs(ctx, px, target, [0])
    (ll, _), = train_step.reference_outputs(ctx, px, target, [0], torch.bfloat16)
    assert float(rl) != float(ll)
