"""What the entries share: the configuration on both sides, the inputs made
from the seed, the measured window, the traced window and the comparison
of a train step's outputs."""

from __future__ import annotations

import math
import random
import statistics
import sys
import time

import torch

from benchmark import yardstick
from benchmark.reference import config as ref_config
from benchmark.reference import rng

# Spans the benchmark puts around the calls it times, in a traced run.
STEP_SPAN = "bench.step"
FORWARD_SPAN = "bench.forward"
PASS_SPAN = "bench.pass"


def log(ctx, what: str) -> None:
    """A progress line on stderr, with the seconds since the process began."""
    print(f"[{time.perf_counter() - ctx.t_start:8.2f} s] {what}", file=sys.stderr, flush=True)


def render_fields(ctx) -> dict:
    """The configuration's renderer fields, with a test's ``shrink``."""
    fields = dict(ctx.config["render"])
    fields.update(ctx.shrink or {})
    return fields


def program_config(ctx, **extra):
    from simple_spectral_torch.config import RenderConfig

    return RenderConfig(**render_fields(ctx), **extra)


def rays_per_sample(cfg) -> int:
    """bench.py's count: 1 camera ray and (max_depth - 1) x (shadow +
    bounce) with explicit light sampling, else max_depth."""
    return 2 * cfg.max_depth - 1 if cfg.els else cfg.max_depth


def step_key(seed: int, i: int) -> torch.Tensor:
    """Step i's key: ``fold_in(fold_in(PRNGKey(seed), i), 0)``."""
    return rng.fold_in(rng.fold_in(rng.PRNGKey(seed), i), 0)


def target_image(seed: int, n_px: int, device) -> torch.Tensor:
    """The target, uniform in [0, 1)^3 per pixel, from the seed, on the
    device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand((n_px, 3), generator=gen, device=device, dtype=torch.float32)


def train_inputs(seed: int, width: int, height: int, lanes: int, device):
    """(pixel of each lane i32[L], target of each lane f32[L, 3]): lane l
    draws pixel ``l % (width * height)``, so each pixel the same number of
    times."""
    n_px = width * height
    px = torch.arange(lanes, dtype=torch.int32, device=device) % n_px
    return px, target_image(seed, n_px, device)[px.to(torch.int64)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(step, seconds: float, go=None):
    """Call ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host clock; every call that started counts, and the window ends
    when the last one has returned.  ``go(flag)`` (a mesh's broadcast of
    rank 0's decision) makes every process stop at the same call.
    Returns (window seconds, [seconds of each call], [each call's output])."""
    outs, times = [], []
    t0 = time.perf_counter()
    i = 0
    while True:
        more = i == 0 or time.perf_counter() - t0 < seconds
        if go is not None:
            more = go(more)
        if not more:
            break
        s = time.perf_counter()
        outs.append(step(i))
        times.append(time.perf_counter() - s)
        i += 1
    return time.perf_counter() - t0, times, outs


def profiled(calls, span_names):
    """Run each (span name, fn) of ``calls`` inside a span of that name
    under ``torch.profiler``; returns ([each call's output], the
    :class:`yardstick.Trace`)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    outs = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls:
            with record_function(name):
                outs.append(fn())
    t0 = time.perf_counter()
    trace = yardstick.trace_from_profiler(prof, span_names)
    print(f"trace: {len(trace.kernels)} kernels, {len(trace.host_ops)} host ops read in "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    return outs, trace


def traced(run, calls, span: str, span_names, untraced) -> list:
    """A traced run's readings: first ``untraced()``, as many calls as
    ``calls`` has in spans named ``span``, made without the profiler and
    timed on the host clock; then ``calls`` under the profiler (see
    :func:`profiled`), read into ``run`` for the calls in those spans.  A
    reader can so set the trace's device time beside a call's wall time
    untraced: the profiler slows the host and not the device, and the
    untraced calls come first so that neither it nor the collection of
    its million events slows them.  Returns the traced calls' outputs."""
    t0 = time.perf_counter()
    untraced()
    untraced_s = time.perf_counter() - t0
    outs, trace = profiled(calls, span_names)
    run.trace, run.breakdown = trace, yardstick.breakdown(trace, span)
    run.busy_s, run.traced_s = trace.busy_us(span) / 1e6, trace.span_us(span) / 1e6
    run.untraced_call_s = untraced_s / len(trace.spans[span])
    return outs


def device_identity(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def memory_peak(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def sample(seed: int, n: int, k: int) -> list:
    """k distinct indices of range(n), drawn from the seed, in order."""
    return sorted(random.Random(seed).sample(range(n), min(k, n)))


def reference_state(ctx, device, **extra):
    """(configuration, colour tables, scene) of the reference, built from the
    data files on ``device``, in float32 with TF32 off."""
    from benchmark.reference import colorimetry, scene_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ref_config.RenderConfig(**render_fields(ctx), **extra)
    tables = colorimetry.build_color_tables(cfg, device=device)
    return cfg, tables, scene_library.build_scene(cfg, tables, device=device)


def check_train(ctx, run, prog: list, reference) -> None:
    """The check of a train cell, once the window has closed and the
    program's state is freed: ``reference()`` gives the reference's
    (loss, grads) of the steps whose outputs ``prog`` holds, and
    ``run.checks`` gets their gaps (:func:`train_gaps`) beside the
    traffic's limits."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = reference()
    log(ctx, f"reference done: {len(ref)} steps")
    loss_gap, grad_gap = train_gaps(prog, ref)
    lim = ctx.traffic["limits"]
    run.checks = {"loss_gap": (loss_gap, lim["loss_gap"]), "grad_gap": (grad_gap, lim["grad_gap"])}


def train_gaps(prog: list, ref: list):
    """The two numbers compared for train steps, each the worst over the
    steps given as (loss, {field: gradient}) pairs:

    - ``loss_gap``: |program loss - reference loss| / |reference loss|;
    - ``grad_gap``: the norm of the difference of a gradient table over the
      larger of the reference's norm of that table and the median of its
      tables' norms (a table the mode does not read has gradient 0)."""
    loss_gap = grad_gap = 0.0
    for (pl, pg), (rl, rg) in zip(prog, ref):
        pl, rl = float(pl), float(rl)
        loss_gap = max(loss_gap, _finite(abs(pl - rl) / abs(rl) if rl else abs(pl - rl)))
        norms = {f: float(torch.linalg.vector_norm(g.double())) for f, g in rg.items()}
        med = statistics.median(norms.values())
        for f, g in rg.items():
            diff = float(torch.linalg.vector_norm(pg[f].to(g.device).double() - g.double()))
            grad_gap = max(grad_gap, _finite(diff / max(norms[f], med)))
    return loss_gap, grad_gap


def _finite(x: float) -> float:
    """x, or inf for NaN and inf, so that a worst-of keeps it."""
    return x if math.isfinite(x) else float("inf")
