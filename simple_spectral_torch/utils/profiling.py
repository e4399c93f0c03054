"""Profiler hooks (PyTorch port of ``simple_spectral_tpu.utils.profiling``).

Usage::

    from simple_spectral_torch.utils.profiling import device_trace
    with device_trace("/tmp/trace") as prof:
        render_image(cfg)

``device_trace`` records the host and, when a card is present, the device
with ``torch.profiler`` and writes a Chrome trace (``trace.json`` in
``log_dir``, which chrome://tracing and Perfetto read).  ``timed_call``
times a call with a device synchronize around each repetition.

``span(name)`` marks a stretch of the program in such a trace: the port
opens its ``ss.*`` spans through it at its layer boundaries (``ss.rng``
threefry draws and key hashing, ``ss.intersect`` closest-hit sweeps,
``ss.shading`` phase 2 of ``trace_lanes``, ``ss.meng`` inside it Meng 2015's
textured albedo once per bounce, ``ss.backward`` the gradient,
``ss.readback`` and ``ss.host_add`` a progressive pass's copy to the host
and its float64 add).  With no profiler running it costs one flag read.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from simple_spectral_torch.utils.metrics import synchronize

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` context while a profiler runs (the flag
    is set for every thread), else one shared null context: about 0.4 us a
    call against 9-11 us for ``record_function`` unguarded."""
    return _autograd_profiler.record_function(name) if _autograd_profiler._is_profiler_enabled else _NO_SPAN


@contextlib.contextmanager
def device_trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_call(fn, *args, reps: int = 3, warmup: int = 1, **kw):
    """Returns (result, best_seconds), the device synchronized around each
    repetition."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args, **kw)
    synchronize(result)
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        result = fn(*args, **kw)
        synchronize(result)
        best = min(best, time.time() - t0)
    return result, best
