"""Readings of the program's own spans: the ``ss.*`` names that
``simple_spectral_torch.utils.profiling.span`` opens at the port's layer
boundaries, frozen here so that a span renamed in the program makes its
metric read None rather than something else.

Each reader takes the calls of one kind ("train" or "render") in the
benchmark's spans of one name (``bench.step``, ``bench.pass``) from
``run.trace``; a program span lands in ``Trace.host_ops`` with its host
interval, on the profiler's one clock, and nested spans of one name count
as their union.  Each returns None where the run has nothing to read:
another kind, no trace, or no span of that name (a program without the
spans).
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from benchmark import yardstick

RNG = "ss.rng"  # threefry draws and key hashing (random.py)
INTERSECT = "ss.intersect"  # each closest-hit sweep with its hit attributes
SHADING = "ss.shading"  # phase 2 of trace_lanes, through the XYZ estimator
BACKWARD = "ss.backward"  # torch.autograd.grad of the train step
READBACK = "ss.readback"  # a pass's chunk sums copied to the host
HOST_ADD = "ss.host_add"  # their float64 add on the host

# Device events that no launch call makes: copies and fills.
COPY_PREFIXES = ("Memcpy", "Memset")

Interval = Tuple[float, float]


def intervals(trace: yardstick.Trace, name: str) -> List[Interval]:
    """The union of the host intervals of the spans named ``name``, as
    sorted disjoint (start, end) pairs."""
    out: List[Interval] = []
    for s, e in sorted((s, e) for n, s, e in trace.host_ops if n == name):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the overlap of two lists of sorted disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _holds(iv: Sequence[Interval], starts: Sequence[float], t: float) -> bool:
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and t < iv[j][1]


def matched_kernels(trace: yardstick.Trace, call_span: str):
    """For each call in the spans named ``call_span``, its (launch time,
    kernel) pairs: the i-th launch call made on the host with the i-th
    device kernel by device start, copies and fills left out, paired over
    the whole trace and grouped by the launch's call.  Exact on one stream,
    where kernels run in launch order; launches from the autograd engine's
    thread count by their host time like any other.  Pairing the whole
    trace, not each call's span alone, keeps a kernel that the profiler's
    clock puts a few microseconds before its call's span with its launch.
    None if the trace's counts differ."""
    calls = trace.spans.get(call_span)
    kernels = [k for k in trace.kernels if not k[0].startswith(COPY_PREFIXES)]
    if not calls or len(kernels) != len(trace.launches):
        return None
    out = []
    for s, e in calls:
        i0, i1 = bisect.bisect_left(trace.launches, s), bisect.bisect_left(trace.launches, e)
        out.append(list(zip(trace.launches[i0:i1], kernels[i0:i1])))
    return out


def _spans_of(run, kind: str, call_span: str, name: str) -> Optional[List[Interval]]:
    tr = run.trace
    if run.kind != kind or tr is None or not tr.spans.get(call_span):
        return None
    return intervals(tr, name) or None


def device_share(run, kind: str, call_span: str, name: str):
    """The device time of the kernels launched inside spans named ``name``
    over that of every kernel of the calls (paired by
    :func:`matched_kernels`, each its own duration)."""
    iv = _spans_of(run, kind, call_span, name)
    pairs = matched_kernels(run.trace, call_span) if iv else None
    if not pairs:
        return None
    starts = [s for s, _ in iv]
    total = inside = 0.0
    for t, (_, ks, ke) in (p for call in pairs for p in call):
        total += ke - ks
        if _holds(iv, starts, t):
            inside += ke - ks
    return inside / total if total > 0 else None


def idle_share(run, kind: str, call_span: str, name: str):
    """The share of the calls' device-idle time (``yardstick.idle_gaps``,
    every device event counted busy) that the host spent inside spans
    named ``name``: each gap split by the spans' intervals, not placed by
    its midpoint."""
    iv = _spans_of(run, kind, call_span, name)
    if not iv:
        return None
    tr = run.trace
    gaps = []
    for lo, hi in tr.spans[call_span]:
        gaps += yardstick.idle_gaps(tr.overlapping(lo, hi), lo, hi)
    gaps.sort()
    total = sum(e - s for s, e in gaps)
    return overlap_us(gaps, iv) / total if total > 0 else None


def host_ms(run, kind: str, call_span: str, name: str):
    """The host time a call spends inside spans named ``name``, the mean
    over the calls, in milliseconds."""
    iv = _spans_of(run, kind, call_span, name)
    if not iv:
        return None
    calls = run.trace.spans[call_span]
    return overlap_us(sorted(calls), iv) / len(calls) / 1e3
