"""Measurement entry points of the port, and what they share.

``bench_megakernel`` (kernel S1, one fused bounce) and ``bench_gather``
(kernel ``gather_u32``, the texel gather) are the port's counterparts of the
JAX package's TPU spikes under ``tools/``; ``chip_smoke.py``, ``bench.py``
and ``profile_render.py`` time the render paths.  This module holds the
card's peak rates, the roofline bound and the CUDA-event timer they use.
Nothing here touches a card when it is imported.
"""

from __future__ import annotations

import statistics
import subprocess

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


def cuda_time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
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
