"""Benchmark of the port: forward+backward Mrays/s on the card.

    python -m simple_spectral_torch.bench [--size 512] [--rounds 3] [--calls 8]

The counterpart of the JAX package's ``bench.py``: ``forward_backward_step``
(render/trainstep.py) on the canonical configuration, cornell-srgb 512x512,
mallett, CIE 1931, 4 hero wavelengths, depth 10, explicit light sampling,
262144 lanes per call (``lanes = min(BENCH_LANES, cfg.max_lanes //
spp_chunk)``, pixels wrapping, target zero), ``spp_chunk`` 1; the metric
keeps ``bench.py``'s name, 64 spp, which no call reads.  Each call folds
its round and its index into the key.  The time of a call is taken
with CUDA events around it, after one warm-up call; a round is K calls, and
the figure is the median over the rounds' Mrays/s, with their spread.  Rays
are counted as ``bench.py`` counts them: 19 per sample at depth 10 (1 camera
ray and 9 x (shadow + bounce)), of which 18 sweeps run (the final sweep's
emission gate is zero under explicit light sampling).

Then each BASELINE configuration (cfg1 rgb, cfg2 mallett, cfg3 meng under
CIE 2006, cfg4 jakob on plane-srgb without explicit light sampling, whose
samples count ``max_depth`` rays) gets the same rounds on the same lane
footing.  Prints one JSON line with
``bench.py``'s keys and ``"device"``, the card's name and power limit.

Numbers are printed unrounded.  Without a card it exits 1.  ``--device
cpu`` (with small ``--lanes`` and ``--max-depth``) runs the same code on
the CPU and times it with the host clock: it checks the program, and its
numbers are not the card's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.trainstep import forward_backward_step

BENCH_LANES = 262144
SPP_CHUNK = 1

# BASELINE.md benchmark configurations 1-4 as bench.py defines them (config 5
# is the multi-host row).
BASELINE_CONFIGS = {
    "cfg1 cornell rgb 128^2": dict(scene="cornell", mode="rgb", width=128, height=128, spp=8, spp_chunk=8),
    "cfg2 cornell-srgb mallett 256^2": dict(scene="cornell-srgb", mode="mallett", width=256, height=256, spp=16),
    "cfg3 cornell-srgb meng 2006 256^2": dict(scene="cornell-srgb", mode="meng", observer=2006, width=256,
                                              height=256, spp=64),
    # the plane converges without ELS (reference src/renderer.cpp:26-30)
    "cfg4 plane-srgb jakob 512^2": dict(scene="plane-srgb", mode="jakob", width=512, height=512, spp=64,
                                        els=False),
}


def device_line(dev: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from simple_spectral_torch.tools import card_line

    return card_line()


def bench_config(cfg: RenderConfig, tables, scene, key, spp_chunk: int, k_calls: int, lanes_cap: int,
                 step_fn=forward_backward_step) -> float:
    """One round: k_calls calls of ``step_fn`` (``forward_backward_step`` by
    default; ``forward_only_step`` times the forward half) at equal lane
    footing; returns Mrays/s over the calls' summed device time (CUDA events)
    or, on the CPU, host time."""
    dev = scene.device
    n_px = cfg.width * cfg.height
    lanes = min(lanes_cap, cfg.max_lanes // max(spp_chunk, 1))
    px = torch.arange(lanes, dtype=torch.int32, device=dev) % n_px
    target = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)

    def step(i):
        return step_fn(scene, tables, cfg, rnd.fold_in(key, i), px, target, spp_chunk)

    step(k_calls)  # warm-up: kernel build, allocator
    if dev.type == "cuda":
        events = []
        for i in range(k_calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(i)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        dt = sum(s.elapsed_time(e) for s, e in events) / 1e3 / k_calls
    else:
        t0 = time.perf_counter()
        for i in range(k_calls):
            step(i)
        dt = (time.perf_counter() - t0) / k_calls
    rays_per_sample = (2 * cfg.max_depth - 1) if cfg.els else cfg.max_depth
    return lanes * spp_chunk * rays_per_sample / dt / 1e6


def _rounds(cfg, spp_chunk, args, dev, key0):
    """bench_config over ``args.rounds`` rounds on a scene built here."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    return [bench_config(cfg, tables, scene, rnd.fold_in(key0, r), spp_chunk, args.calls, args.lanes)
            for r in range(args.rounds)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--calls", type=int, default=8, help="calls per round (K)")
    p.add_argument("--lanes", type=int, default=BENCH_LANES, help="lane cap per call")
    p.add_argument("--max-depth", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device is available (--device cpu checks the program only)", file=sys.stderr)
        return 1
    device = device_line(dev)
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=args.size, height=args.size,
                       max_depth=args.max_depth)
    key = rnd.PRNGKey(0)
    samples = _rounds(cfg, SPP_CHUNK, args, dev, key)
    for r, m in enumerate(samples):
        print(f"round {r}: {m:.3f} Mrays/s", file=sys.stderr)
    mrays = statistics.median(samples)

    per_config = {}
    for ci, (name, kw) in enumerate(BASELINE_CONFIGS.items()):
        kw = dict(kw)
        chunk = kw.pop("spp_chunk", SPP_CHUNK)
        c = RenderConfig(**kw, max_depth=args.max_depth)
        ms = _rounds(c, chunk, args, dev, rnd.fold_in(key, 100 + 10 * ci))
        per_config[name] = statistics.median(ms)
        print(f"{name}: {per_config[name]:.3f} Mrays/s (rounds {[round(x, 3) for x in ms]})", file=sys.stderr)

    print(json.dumps({
        "metric": f"Mrays/s/chip fwd+bwd cornell-srgb {args.size}^2@64spp mallett",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / 100.0,
        "spread": [min(samples), max(samples)],
        "rounds": args.rounds,
        "calls_per_round": args.calls,
        "lanes_per_call": min(args.lanes, cfg.max_lanes // SPP_CHUNK),
        "rays_per_sample_equivalent": 2 * cfg.max_depth - 1,
        "intersects_per_sample_actual": (2 * cfg.max_depth - 2) if cfg.els else cfg.max_depth,
        "honest_18_sweep": mrays * (2 * cfg.max_depth - 2) / (2 * cfg.max_depth - 1),
        "configs": per_config,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
