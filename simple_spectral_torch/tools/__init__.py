"""Measurement entry points of the port, and what they share.

``bench_megakernel`` (kernel S1, one fused bounce) and ``bench_gather``
(kernel ``gather_u32``, the texel gather) are the port's counterparts of the
JAX package's TPU spikes under ``tools/``; ``scaling_bench`` is the
counterpart of ``tools/scaling_bench.py`` (weak scaling of the sharded
train step over cards, in one process or one process per card);
``chip_smoke.py``, ``bench.py`` and ``profile_render.py`` time the render
paths.  This module holds the
card's peak rates, the roofline bound and the two CUDA-event timers they
use: :func:`cuda_time_ms`, the device's time alone, and
:func:`host_inclusive_ms`, for calls that wait for the device inside.
Nothing here touches a card when it is imported.
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import sys
import time

# Peak rates of one H100 SXM (NVIDIA data sheet, 700 W): HBM bandwidth and
# non-tensor FP32 throughput.
H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
# FP32 operations of one watertight (ray, triangle) test whatever the data:
# 9 (v - o) + 12 shear + 9 barycentrics + 2 det + 6 scaled distance.  The
# one division of each candidate that passes the edge test is left out, so
# a bound built on it is a floor.
OPS_PER_TRIANGLE_TEST = 38


def bound_ms(ops: float, bytes_moved: float):
    """Least time the card could take: the larger of the FP32 operations
    over the FP32 peak and the bytes over the memory rate.  Returns
    (ms, "operations" | "bytes", ops_ms, bytes_ms)."""
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), ops_ms, bytes_ms


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(device_index: int) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the card."""
    import torch

    cycles = 20_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles // 10)  # warm-up
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


# Doublings of the spin before cuda_time_ms gives up: a call that still
# outlasts it waits for the device inside, and host_inclusive_ms times it.
SPIN_TRIES = 6


def cuda_time_ms(fn, reps: int = 100, warmup: int = 3) -> float:
    """The card's time for one call of ``fn``, the host's work left out.

    After ``warmup`` calls it enqueues a device spin (``torch.cuda._sleep``)
    long enough for the host to enqueue the whole run behind it, then the
    start event, ``reps`` calls back to back and the end event, and returns
    the elapsed time over ``reps``.  The spin starts at twice the host's
    measured enqueue time of the run.  If the spin has ended before the last
    call was enqueued (the event recorded after it has completed), the
    device may have waited for the host inside the run: it says so on
    stderr, doubles the spin and runs again, and raises after SPIN_TRIES
    runs, since ``fn`` then waits for the device inside.  The L2 cache stays
    warm between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    per_ms = _spin_cycles_per_ms(torch.cuda.current_device())
    spin_ms = max(1.0, 2.0 * reps * host_ms)
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * per_ms))
        start.record()
        for _ in range(reps):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        print(f"cuda_time_ms: a {spin_ms:.3f} ms spin ended before the host had enqueued {reps} calls; "
              f"doubling it", file=sys.stderr)
        spin_ms *= 2.0
    raise RuntimeError(f"cuda_time_ms: the host still outlasts a {spin_ms / 2.0:.3f} ms spin: the call waits "
                       f"for the device inside; time it with host_inclusive_ms")


def host_inclusive_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` each
    (after one warm-up), the host's work for the call inside the events: for
    calls that wait for the device inside, such as the plain twins that read
    a count back.  Figures from it are host-inclusive."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
