"""Whole images rendered one after another, one caller in a closed loop:
``simple_spectral_torch.render.progressive.ProgressiveRenderer.run_pass``
with the native float64 accumulator.

Image k gets a new renderer on the seed word ``fold_in(PRNGKey(seed), k)[1]``
and renders ``image_spp`` samples per pixel in passes of ``pass_spp``; a
finished image ends in its sRGB image (``image()``).  No checkpoint and no
file is written.  The window's work is the passes whose sums are in the
host accumulator by its end.

Traffic keys: ``image_spp``, ``pass_spp``, ``warmup_passes`` (set-up passes
of a renderer that is then dropped), ``trace_passes`` (passes made
untraced, then as many traced),
``limits`` (of ``pixel_gap``, see :func:`pixel_gap`, between the checked
image's per-pixel value means and the reference's, over the passes it has).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import common
from benchmark.harness import Run
from benchmark.reference import rng
from benchmark.reference import steps as ref_steps

# Where a test plants a fault under the timed path (see train_step): the
# chunk renderer that each pass calls.
FAULT_HOOKS = (("simple_spectral_torch.render.progressive", "_render_chunk", "render", 4),)


def image_seed(seed: int, k: int) -> int:
    """Image k's renderer seed: the low word of ``fold_in(PRNGKey(seed), k)``."""
    return int(rng.fold_in(rng.PRNGKey(seed), k)[1])


def reference_means(ctx, img_seed: int, spp_done: int, device, shade_dtype=torch.float32) -> np.ndarray:
    """The reference's per-pixel value means f64[P, 3] of an image's first
    ``spp_done`` samples, with its own tables and scene."""
    pass_spp = int(ctx.traffic["pass_spp"])
    cfg, tables, scene = common.reference_state(ctx, device, spp=int(ctx.traffic["image_spp"]))
    sums, _ = ref_steps.image_sums(scene, tables, cfg, img_seed, pass_spp, spp_done // pass_spp, shade_dtype)
    return sums / spp_done


def pixel_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """The worst pixel value: the largest |prog - ref| over the reference's
    value, or over the image's mean value where that is larger (a dark
    pixel's own value is no scale); inf where the program gave no number."""
    mag = np.abs(ref)
    gap = float(np.max(np.abs(prog - ref) / np.maximum(mag, mag.mean())))
    return gap if math.isfinite(gap) else float("inf")


def control(ctx) -> dict:
    """The control's number: the reference with bfloat16 shading against
    the float32 one over the cell's first whole image."""
    spp = int(ctx.traffic["image_spp"])
    seed = image_seed(ctx.seed, 0)
    dev = torch.device(ctx.device)
    ref = reference_means(ctx, seed, spp, dev)
    return {"pixel_gap": pixel_gap(reference_means(ctx, seed, spp, dev, torch.bfloat16), ref)}


def run(ctx) -> Run:
    from simple_spectral_torch.render.progressive import ProgressiveRenderer
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    t = ctx.traffic
    dev = torch.device(ctx.device)
    pass_spp, image_spp = int(t["pass_spp"]), int(t["image_spp"])
    cfg = common.program_config(ctx, spp=image_spp)
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    common.log(ctx, "tables, scene and inputs built")

    def renderer(k):
        return ProgressiveRenderer(cfg, scene, tables, seed=image_seed(ctx.seed, k), spp_per_pass=pass_spp,
                                   native=True)

    warm = renderer(0)
    for _ in range(int(t["warmup_passes"])):
        warm.run_pass()
    warm.image()
    del warm
    common.sync(dev)
    run = Run(kind="render", setup_s=time.perf_counter() - ctx.t_start, device_kind=common.device_identity(dev),
              facts={"k1_rays": cfg.width * cfg.height, "n_tris": scene.n_tris})
    common.log(ctx, "set-up done")
    images = [renderer(0)]

    def one_pass(i):
        pr = images[-1]
        pr.run_pass()
        if pr.spp_done == image_spp:
            pr.image()
            images.append(renderer(len(images)))

    if ctx.trace:
        n = int(t["trace_passes"])
        common.traced(run, [(common.PASS_SPAN, lambda i=i: one_pass(i)) for i in range(n)], common.PASS_SPAN,
                      (common.PASS_SPAN,), lambda: [one_pass(i) for i in range(n, 2 * n)])
        passes = 2 * n
    else:
        run.window_s, run.step_s, _ = common.window(one_pass, ctx.seconds)
        passes = len(run.step_s)
    common.log(ctx, f"{passes} passes done")
    run.attempted = passes
    run.rays = float(passes * cfg.width * cfg.height * pass_spp * common.rays_per_sample(cfg))
    run.memory_peak_bytes = common.memory_peak(dev)

    # the image checked: drawn from the seed among the finished ones, or
    # the one in progress when none has finished
    done = [k for k, pr in enumerate(images) if pr.spp_done == image_spp] or [len(images) - 1]
    k = done[common.sample(ctx.seed, len(done), 1)[0]]
    spp_done = images[k].spp_done
    prog = images[k].mean_value()[0].reshape(-1, 3)
    del images, scene, tables
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap = pixel_gap(prog, reference_means(ctx, image_seed(ctx.seed, k), spp_done, dev))
    common.log(ctx, f"reference done: {spp_done} samples of image {k}")
    run.checks = {"pixel_gap": (gap, t["limits"]["pixel_gap"])}
    return run
