"""Where the time of one forward render goes on the card.

    python -m simple_spectral_torch.profile_render [--scene cornell-srgb] [--width 512] [--height 512] [--spp 1]

Renders one of two configurations through ``render_image`` three times: a
warm-up, one timed run, and one under ``torch.profiler``.  ``cornell-srgb``
is the first slice's path (mallett, CIE 1931, 4 hero wavelengths, depth 10,
explicit light sampling, kernel K1); ``cornell-stress`` is the scale path
(rgb, 5000 boxes and 250 spheres, depth 10, explicit light sampling,
intersect_impl "auto", kernel K2).  Prints the timed run's wall time, the
device kernel time of the profiled run summed over kernels, the device's
busy and idle shares of the timed run's wall time, the number of kernel
launches per sample, the launches of K1 and K2, and the ops that take the
most device time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import cull, intersect_pallas
from simple_spectral_torch.render.renderer import render_image
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables


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
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    render_image(cfg, scene, tables, device=dev)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    render_image(cfg, scene, tables, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0

    intersect_pallas.LAUNCHES = cull.LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_image(cfg, scene, tables, device=dev)
        torch.cuda.synchronize()
    k1_launches, k2_launches = intersect_pallas.LAUNCHES, cull.LAUNCHES
    avgs = prof.key_averages()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    rows = sorted(avgs, key=_self_device_us, reverse=True)[: args.top]

    print(f"{cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp {cfg.mode} depth {cfg.max_depth}, "
          f"on {torch.cuda.get_device_name(0)}")
    print(f"wall {wall_s * 1e3:.3f} ms (unprofiled); device kernel time {busy_us / 1e3:.3f} ms over "
          f"{len(kernels)} kernels; busy share {busy_us / 1e6 / wall_s:.4f}, idle share "
          f"{1.0 - busy_us / 1e6 / wall_s:.4f}")
    print(f"kernel launches {launches} ({launches / cfg.spp:.0f} per sample), K1 launches {k1_launches}, "
          f"K2 launches {k2_launches}")
    print(f"{'op':60s} {'calls':>7s} {'self device ms':>15s} {'self cpu ms':>12s}")
    for e in rows:
        print(f"{e.key[:60]:60s} {e.count:7d} {_self_device_us(e) / 1e3:15.3f} {e.self_cpu_time_total / 1e3:12.3f}")
    print(json.dumps({
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "scene": cfg.scene, "kernels": len(kernels), "launches": launches, "k1_launches": k1_launches,
        "k2_launches": k2_launches,
        "top": [{"op": e.key, "calls": e.count, "self_device_ms": _self_device_us(e) / 1e3} for e in rows],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
