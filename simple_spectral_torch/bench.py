"""Benchmark of the port: forward+backward Mrays/s on the card.

    python -m simple_spectral_torch.bench [--size 512] [--rounds 3] [--calls 8]

The counterpart of the JAX package's ``bench.py``: ``forward_backward_step``
(render/trainstep.py) on the canonical configuration, cornell-srgb 512x512,
mallett, CIE 1931, 4 hero wavelengths, depth 10, explicit light sampling,
262144 lanes per call (``lanes = min(BENCH_LANES, cfg.max_lanes //
spp_chunk)``, pixels wrapping, target zero), ``spp_chunk`` 1; the metric
keeps ``bench.py``'s name, 64 spp, which no call reads.

The keys are ``bench.py``'s (``bench.py:64-71``, ``:155-158``): round r of
the headline runs on ``k_r = fold_in(PRNGKey(0), r)``, round r of BASELINE
configuration ci on ``k_r = fold_in(PRNGKey(0), 100 + 10 ci + r)``, and call
i of a round on ``fold_in(fold_in(k_r, i), 0)``: ``bench.py`` folds in a
chain token, ``int32(loss * 1e-30)``, which is 0 for any finite loss.  A
round makes two warm-up calls (i = 0, 1, as ``timeit_chained`` does), then
K calls (i = 0 .. K - 1), each timed with CUDA events around it; its figure
is Mrays/s over their summed time.  The headline is the median over the
rounds' figures, with their spread.  Every round, the headline's and the
configurations', makes K calls: ``--calls``, 8 by default, where
``bench.py`` makes K = 32 per headline round and ``max(K // 2, 8)`` = 16 per
configuration round on a host-clock timer; the JSON line gives K as
``calls_per_round``.  Rays are counted as ``bench.py`` counts them: 19 per
sample at depth 10 (1 camera ray and 9 x (shadow + bounce)), of which 18
sweeps run (the final sweep's emission gate is zero under explicit light
sampling).

Then each BASELINE configuration (cfg1 rgb, cfg2 mallett, cfg3 meng under
CIE 2006, cfg4 jakob on plane-srgb without explicit light sampling, whose
samples count ``max_depth`` rays) gets ``--rounds`` rounds on the same lane
footing.  As in ``bench.py``, a configuration that raises (an out-of-memory,
a build error) is recorded as ``"error: <repr>"`` under its name in
``configs`` and the run goes on; the headline's rounds are not guarded.
Prints one JSON line with ``bench.py``'s keys and ``"device"``, the card's
name and power limit, and then returns 1 if a configuration failed, else 0.

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
from simple_spectral_torch.render import trainstep
from simple_spectral_torch.tools import WARMUP_CALLS, guarded

BENCH_LANES = 262144
SPP_CHUNK = 1

# bench.py's first key of a configuration's rounds: 100 + 10 ci + r
CONFIG_KEY_BASE, CONFIG_KEY_STRIDE = 100, 10

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


def call_key(round_key, i: int):
    """Call i's key in a round: bench.py's ``fold_in(fold_in(k_r, i), tok)``
    with its chain token, 0 for a finite loss."""
    return rnd.fold_in(rnd.fold_in(round_key, i), 0)


def bench_config(cfg: RenderConfig, tables, scene, key, spp_chunk: int, k_calls: int, lanes_cap: int,
                 step_fn=None) -> float:
    """One round on round key ``key``: WARMUP_CALLS calls, then k_calls calls
    of ``step_fn`` (``forward_backward_step`` by default;
    ``forward_only_step`` times the forward half) at equal lane footing;
    returns Mrays/s over the timed calls' summed device time (CUDA events)
    or, on the CPU, host time."""
    step_fn = step_fn or trainstep.forward_backward_step
    dev = scene.device
    n_px = cfg.width * cfg.height
    lanes = min(lanes_cap, cfg.max_lanes // max(spp_chunk, 1))
    px = torch.arange(lanes, dtype=torch.int32, device=dev) % n_px
    target = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)

    def step(i):
        return step_fn(scene, tables, cfg, call_key(key, i), px, target, spp_chunk)

    for i in range(WARMUP_CALLS):  # kernel build, allocator
        step(i)
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


def _rounds(cfg, spp_chunk, args, dev, round_key):
    """bench_config over ``args.rounds`` rounds on a scene built here;
    ``round_key(r)`` is round r's key."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    return [bench_config(cfg, tables, scene, round_key(r), spp_chunk, args.calls, args.lanes)
            for r in range(args.rounds)]


def _config_rounds(ci: int, kw: dict, args, dev, key) -> list:
    """BASELINE configuration ci's rounds, on bench.py's keys."""
    kw = dict(kw)
    chunk = kw.pop("spp_chunk", SPP_CHUNK)
    c = RenderConfig(**kw, max_depth=args.max_depth)
    return _rounds(c, chunk, args, dev, lambda r: rnd.fold_in(key, CONFIG_KEY_BASE + CONFIG_KEY_STRIDE * ci + r))


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
    samples = _rounds(cfg, SPP_CHUNK, args, dev, lambda r: rnd.fold_in(key, r))
    for r, m in enumerate(samples):
        print(f"round {r}: {m:.3f} Mrays/s", file=sys.stderr)
    mrays = statistics.median(samples)

    per_config = {}
    for ci, (name, kw) in enumerate(BASELINE_CONFIGS.items()):
        ms, err = guarded(name, _config_rounds, ci, kw, args, dev, key)
        if err:
            per_config[name] = f"error: {err}"
            continue
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
    return 1 if any(isinstance(v, str) for v in per_config.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
