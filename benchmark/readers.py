"""Readings that several metrics share, each for the calls of one kind
("train" or "render") in the spans of one name; a metric's file in
``benchmark/metrics/`` picks the kind and the span.  Each returns None
where the run has nothing to read."""

from __future__ import annotations


def rate_mrays_s(run, kind: str):
    """Rays of the work completed in the window over its host-clock
    seconds, in millions."""
    if run.kind != kind or not run.window_s:
        return None
    return run.rays / run.window_s / 1e6


def launches_per_call(run, kind: str, span: str):
    """Kernel launches the host makes in one traced call (the CUDA
    runtime's launch calls inside the call's span)."""
    spans = run.trace.spans.get(span) if run.trace is not None else None
    if run.kind != kind or not spans:
        return None
    return run.trace.launches_in(span) / len(spans)


def device_idle(run, kind: str, span: str):
    """One minus the device's busy time of a call (the union of its
    kernels' intervals, from the trace) over a call's wall time without
    the profiler (the calls made untraced after the trace): the profiler
    slows the host and not the device, so a traced call's own wall time
    would count the profiler's cost as idle."""
    tr = run.trace
    if run.kind != kind or tr is None or not tr.spans.get(span) or not run.untraced_call_s:
        return None
    return 1.0 - tr.busy_us(span) / len(tr.spans[span]) / 1e6 / run.untraced_call_s
