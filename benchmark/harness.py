"""The benchmark's harness: one cell, one run, one result line.

Everything that belongs to one configuration, traffic mix or metric is found
by its name in ``BENCHMARK.json``:

- a configuration is ``configs[].file``, a JSON file whose ``render`` object
  holds the renderer's configuration fields;
- a traffic mix is ``benchmark/traffic/<traffic>.json``; its ``entry`` names
  the module ``benchmark/entries/<entry>.py`` that sets up, drives and
  checks the program, and the rest are that entry's parameters (lanes,
  samples, passes, how many outputs to check and their limits);
- a metric is ``benchmark/metrics/<name>.py``, whose ``read(run)`` takes the
  :class:`Run` record of the window (and of the trace, in a traced run) and
  returns the value, or None when there is nothing to read.

An entry's ``run(ctx)`` returns a :class:`Run`.  This module picks the
cell's metrics (its ``end_to_end`` metrics, or its ``per_layer`` metrics
with ``--trace 1``), reads each, and prints the result line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# Top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "simple_spectral_tpu")


@dataclasses.dataclass
class Context:
    """What an entry is given: the cell, its files' contents and the run's
    arguments.  ``shrink`` (tests only) overrides configuration fields to
    run the cell at a tiny size; ``world`` overrides the cell's chips."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    chips: int
    t_start: float
    device: str = "cuda"
    shrink: Optional[dict] = None
    world: Optional[int] = None


@dataclasses.dataclass
class Run:
    """One run's record, which the metric readers read.

    ``kind`` is the cell's kind of work ("train" or "render");
    ``step_s`` the host-clock seconds of each step or pass of the window;
    ``rays`` the rays of the work completed in it; ``trace`` the
    :class:`yardstick.Trace` of a traced run and ``untraced_call_s`` the
    host-clock seconds of one call made after it without the profiler;
    ``facts`` what a reader needs
    of the cell (lanes, triangles, steps traced).  ``checks`` maps each
    compared number to (value, limit)."""

    kind: str
    setup_s: float
    window_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    rays: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    device_kind: str = ""
    device_count: int = 1
    busy_s: Optional[float] = None
    traced_s: Optional[float] = None
    trace: object = None
    untraced_call_s: Optional[float] = None
    breakdown: Optional[dict] = None
    facts: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, workload: str, root: str = ROOT):
    """(workload entry, configuration file's contents, traffic file's
    contents) of a cell, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json"))
    if int(traffic["chips"]) != int(w["chips"]):
        raise ValueError(f"traffic {w['traffic']} runs on {traffic['chips']} chip(s), cell {workload} asks for {w['chips']}")
    return w, config, traffic


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metrics a run of the cell prints: its end-to-end metrics, or with
    ``trace`` its per-layer ones; a metric without ``workloads`` belongs to
    every cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_module(kind: str, name: str, root: str = ROOT):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(root, "benchmark", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(spec: dict, workload: str, run: Run, trace: bool, root: str = ROOT) -> dict:
    out = {}
    for m in cell_metrics(spec, workload, trace):
        value = load_module("metrics", m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    """Forbidden top-level modules present in ``sys.modules``, compared by
    whole top-level names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def result_line(run: Run, metrics: dict, trace: bool) -> dict:
    device = {"platform": "gpu", "kind": run.device_kind, "count": run.device_count,
              "memory_peak_bytes": run.memory_peak_bytes}
    if trace:
        device["busy_s"] = run.busy_s
        device["window_s"] = run.traced_s
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if trace and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    # a value that is not finite is written as its name ("inf"): JSON has no such number
    line["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def context(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", shrink=None, world=None,
            t_start=None, root: str = ROOT) -> Context:
    """The :class:`Context` of one run of a cell."""
    w, config, traffic = cell(load_spec(root), workload, root)
    return Context(workload=workload, seed=seed, seconds=seconds, trace=trace, config=config, traffic=traffic,
                   chips=int(w["chips"]), t_start=time.perf_counter() if t_start is None else t_start,
                   device=device, shrink=shrink, world=world)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", shrink=None,
             world=None, t_start=None, root: str = ROOT) -> Run:
    """Run one cell once through its entry (no look for a card: the CLI
    makes it)."""
    ctx = context(workload, seed, seconds, trace, device, shrink, world, t_start, root)
    entry = importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}")
    return entry.run(ctx)


def report(spec: dict, workload: str, run: Run, trace: bool, root: str = ROOT) -> dict:
    """Print the compared numbers on stderr, then return the result line."""
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return result_line(run, read_metrics(spec, workload, run, trace, root), trace)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = load_spec()
    w, _, _ = cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {w['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 1
    print(f"[{time.perf_counter() - t_start:8.2f} s] torch imported, {torch.cuda.device_count()} CUDA device(s)",
          file=sys.stderr, flush=True)
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    line = report(spec, args.workload, run, bool(args.trace))
    found = forbidden_loaded()
    if found:
        print(f"benchmark: the process holds forbidden modules {found}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
