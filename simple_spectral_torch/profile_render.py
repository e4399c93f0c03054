"""Where the time of one forward render, or of one training step, goes on
the card.

    python -m simple_spectral_torch.profile_render [--step render|train|progressive] [--scene cornell-srgb]
        [--width 512] [--height 512] [--spp 1]

``--step render`` (the default) renders one of four configurations through
``render_image`` three times: a warm-up, one timed run, and one under
``torch.profiler``.  ``cornell-srgb`` is the first slice's path (mallett,
CIE 1931, 4 hero wavelengths, depth 10, explicit light sampling, kernel
K1); ``cornell-stress`` is the scale path (rgb, 5000 boxes and 250 spheres,
depth 10, explicit light sampling, intersect_impl "auto", kernel K2);
``cfg3`` and ``cfg4`` are bench.py's BASELINE configurations 3 (cornell-srgb,
meng, CIE 2006, explicit light sampling) and 4 (plane-srgb, jakob, without
explicit light sampling), both through K1 with u32 texels.  Every
configuration renders at ``--width`` x ``--height`` (512x512 by default,
whatever size bench.py gives it), so that the step's lanes are the bench's
262144.
``--step train`` does the same with one ``forward_backward_step`` over all
pixels of the frame (bench.py's call at 512x512: 262144 lanes, spp 1,
target zero), and profiles ``forward_only_step`` on the same inputs too, so
that the backward's share of the device time is the step's device time
less the forward's, over the step's.
``--step progressive`` profiles one pass of ``--spp`` samples of the CLI's
own path, ``ProgressiveRenderer.run_pass`` with the native accumulator
(the device's chunk sums copied to the host and added in f64).

Prints the timed run's wall time, the device kernel time of the profiled
run summed over kernels, the device's busy and idle shares of the timed
run's wall time, the number of kernel launches per sample (per call for the
step), the launches of K1 and K2 with their device milliseconds per launch
(the profiler's device timeline: the card's time alone, as
``tools.cuda_time_ms`` gives a kernel's), and the ops that take the most
device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import cull, intersect_pallas
from simple_spectral_torch.render.progressive import ProgressiveRenderer
from simple_spectral_torch.render.renderer import render_image
from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables
from simple_spectral_torch.tools import profile_call


def _self_device_us(evt) -> float:
    """An event's own device time in microseconds, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


CONFIGS = {
    "cornell-srgb": dict(scene="cornell-srgb", mode="mallett", observer=1931, n_wavelengths=4, max_depth=10,
                         els=True),
    "cornell-stress": dict(scene="cornell-stress", mode="rgb", stress_boxes=5000, stress_spheres=250,
                           stress_materials=16, max_depth=10, els=True, intersect_impl="auto"),
    "cfg3": dict(scene="cornell-srgb", mode="meng", observer=2006, n_wavelengths=4, max_depth=10, els=True),
    "cfg4": dict(scene="plane-srgb", mode="jakob", observer=1931, n_wavelengths=4, max_depth=10, els=False),
}


# device-side names of the port's kernels on the render paths
_PORT_KERNELS = {"K1": "best_key_kernel", "K2": "cull_best_kernel"}


def _profile(fn, top: int):
    """Run ``fn`` three times (warm-up, timed, profiled); returns the timed
    wall seconds, the profiled run's device kernel microseconds, its kernel
    count and launch count, the K1 and K2 launches, the device
    milliseconds per launch of each port kernel that ran, and the top
    ops."""
    fn()  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    intersect_pallas.LAUNCHES = cull.LAUNCHES = 0
    avgs, kernels, launches, busy_us = profile_call(fn)
    k_launches = (intersect_pallas.LAUNCHES, cull.LAUNCHES)
    per_launch = {}
    for label, name in _PORT_KERNELS.items():
        times = [e.time_range.elapsed_us() for e in kernels if name in e.name]
        if times:
            per_launch[label] = sum(times) / len(times) / 1e3
    rows = sorted(avgs, key=_self_device_us, reverse=True)[:top]
    return wall_s, busy_us, len(kernels), launches, k_launches, per_launch, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--step", choices=("render", "train", "progressive"), default="render")
    p.add_argument("--scene", choices=sorted(CONFIGS), default="cornell-srgb")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp, **CONFIGS[args.scene])
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    extra = {}
    if args.step == "render":
        wall_s, busy_us, n_kernels, launches, (k1, k2), per_launch, rows = _profile(
            lambda: render_image(cfg, scene, tables, device=dev), args.top)
        per, unit = cfg.spp, "sample"
        what = f"render {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp"
    elif args.step == "progressive":
        wall_s, busy_us, n_kernels, launches, (k1, k2), per_launch, rows = _profile(
            lambda: ProgressiveRenderer(cfg, scene, tables, spp_per_pass=cfg.spp, native=True).run_pass(), args.top)
        per, unit = cfg.spp, "sample"
        what = f"progressive pass {cfg.scene} {cfg.width}x{cfg.height}, {cfg.spp} spp"
    else:
        n_px = cfg.width * cfg.height
        px = torch.arange(n_px, dtype=torch.int32, device=dev)
        target = torch.zeros((n_px, 3), dtype=torch.float32, device=dev)
        key = rnd.PRNGKey(0)
        wall_s, busy_us, n_kernels, launches, (k1, k2), per_launch, rows = _profile(
            lambda: forward_backward_step(scene, tables, cfg, key, px, target, args.spp), args.top)
        f_wall, f_busy, _, f_launches, _, _, _ = _profile(
            lambda: forward_only_step(scene, tables, cfg, key, px, target, args.spp), args.top)
        per, unit = 1, "call"
        what = f"forward_backward_step {cfg.scene} {n_px} lanes x {args.spp} spp"
        extra = {"forward_wall_ms": f_wall * 1e3, "forward_device_busy_ms": f_busy / 1e3,
                 "forward_launches": f_launches, "backward_device_share": 1.0 - f_busy / busy_us}
    busy_share = busy_us / 1e6 / wall_s
    print(f"{what}, {cfg.mode} depth {cfg.max_depth}, on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_s * 1e3:.3f} ms (unprofiled); device kernel time {busy_us / 1e3:.3f} ms over "
          f"{n_kernels} kernels; busy share {busy_share:.4f}, idle share {1.0 - busy_share:.4f}")
    print(f"kernel launches {launches} ({launches / per:.0f} per {unit}), K1 launches {k1}, K2 launches {k2}; "
          + ", ".join(f"{k} {ms:.4f} ms per launch on the device" for k, ms in per_launch.items()))
    if extra:
        print(f"forward only: wall {extra['forward_wall_ms']:.3f} ms, device {extra['forward_device_busy_ms']:.3f} ms, "
              f"{extra['forward_launches']} launches; the backward's share of the step's device time "
              f"{extra['backward_device_share']:.4f}")
    print(f"{'op':60s} {'calls':>7s} {'self device ms':>15s} {'self cpu ms':>12s}")
    for e in rows:
        print(f"{e.key[:60]:60s} {e.count:7d} {_self_device_us(e) / 1e3:15.3f} {e.self_cpu_time_total / 1e3:12.3f}")
    print(json.dumps({
        "step": args.step, "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_share,
        "scene": cfg.scene, "kernels": n_kernels, "launches": launches, "k1_launches": k1, "k2_launches": k2,
        "device_ms_per_launch": per_launch,
        **extra,
        "top": [{"op": e.key, "calls": e.count, "self_device_ms": _self_device_us(e) / 1e3} for e in rows],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
