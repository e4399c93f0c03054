"""The train step of an inverse-rendering job, one caller in a closed loop:
``simple_spectral_torch.render.trainstep.forward_backward_step``.

Step i renders ``lanes_per_pixel`` lanes of every pixel (lane l on pixel
``l % pixels``), ``spp`` samples each, on ``fold_in(fold_in(PRNGKey(seed),
i), 0)``, against a target uniform in [0, 1)^3 per pixel drawn from the
seed, and ends when its loss is on the host, as a training loop logs it.

Traffic keys: ``lanes_per_pixel``, ``spp``, ``warmup_calls`` (set-up calls
on steps 0, 1, ...), ``check_steps`` (steps drawn from the seed among the
window's, or the traced ones, and recomputed by the reference),
``trace_steps`` (steps made untraced, then as many traced and as many
forward-only steps on the same inputs), ``limits`` (of ``loss_gap`` and
``grad_gap``, see ``common.train_gaps``).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import common
from benchmark.harness import Run
from benchmark.reference import steps as ref_steps

# Where a test plants a fault under the timed path: (module, function, kind
# of output, index of the lanes among its arguments); see tests/faults.py.
FAULT_HOOKS = (("simple_spectral_torch.render.trainstep", "forward_backward_step", "train", 4),)


def reference_outputs(ctx, px, target, steps, shade_dtype=torch.float32) -> list:
    """The reference's (loss, grads) of the given steps, on the inputs'
    device, with its own tables and scene; ``shade_dtype`` bfloat16 gives
    the control."""
    cfg, tables, scene = common.reference_state(ctx, px.device)
    spp = int(ctx.traffic["spp"])
    return [ref_steps.loss_and_grads(scene, tables, cfg, common.step_key(ctx.seed, i), px, target, spp, shade_dtype)
            for i in steps]


def control(ctx) -> dict:
    """The control's numbers: the reference with bfloat16 shading against
    the float32 one on the cell's first ``check_steps`` steps."""
    fields = common.render_fields(ctx)
    lanes = fields["width"] * fields["height"] * int(ctx.traffic["lanes_per_pixel"])
    px, target = common.train_inputs(ctx.seed, fields["width"], fields["height"], lanes, torch.device(ctx.device))
    steps = list(range(int(ctx.traffic["check_steps"])))
    ref = reference_outputs(ctx, px, target, steps)
    loss_gap, grad_gap = common.train_gaps(reference_outputs(ctx, px, target, steps, torch.bfloat16), ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap}


def run(ctx) -> Run:
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    t = ctx.traffic
    dev = torch.device(ctx.device)
    cfg = common.program_config(ctx)
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    lanes = cfg.width * cfg.height * int(t["lanes_per_pixel"])
    spp = int(t["spp"])
    px, target = common.train_inputs(ctx.seed, cfg.width, cfg.height, lanes, dev)
    common.log(ctx, "tables, scene and inputs built")

    def step(i):
        loss, grads = forward_backward_step(scene, tables, cfg, common.step_key(ctx.seed, i), px, target, spp)
        return loss.item(), grads

    def forward(i):
        return forward_only_step(scene, tables, cfg, common.step_key(ctx.seed, i), px, target, spp).item()

    for i in range(int(t["warmup_calls"])):
        step(i)
    common.sync(dev)
    run = Run(kind="train", setup_s=time.perf_counter() - ctx.t_start, device_kind=common.device_identity(dev),
              facts={"k1_rays": lanes, "n_tris": scene.n_tris})
    common.log(ctx, "set-up done")
    if ctx.trace:
        n = int(t["trace_steps"])
        calls = [(common.STEP_SPAN, lambda i=i: step(i)) for i in range(n)]
        calls += [(common.FORWARD_SPAN, lambda i=i: forward(i)) for i in range(n)]
        outs = common.traced(run, calls, common.STEP_SPAN, (common.STEP_SPAN, common.FORWARD_SPAN),
                             lambda: [step(i) for i in range(n, 2 * n)])[:n]
    else:
        run.window_s, run.step_s, outs = common.window(step, ctx.seconds)
    checked = common.sample(ctx.seed, len(outs), int(t["check_steps"]))
    common.log(ctx, f"{len(outs)} steps done")
    run.attempted = len(outs)
    run.failed = sum(not math.isfinite(loss) for loss, _ in outs)
    run.rays = float(len(outs) * lanes * spp * common.rays_per_sample(cfg))
    run.memory_peak_bytes = common.memory_peak(dev)

    prog = [outs[i] for i in checked]
    del scene, tables, outs
    common.check_train(ctx, run, prog, lambda: reference_outputs(ctx, px, target, checked))
    return run
