"""The benchmark's frozen yardsticks: published peaks, kernel K1's work, and
the readers of a ``torch.profiler`` trace.

These are copies, held here so that a later change to the program cannot
move what it is measured against:

- the peaks of one H100 SXM at 700 W (NVIDIA's data sheet: non-tensor FP32
  and HBM bandwidth);
- the operations and bytes of one launch of K1, the dense closest-hit sweep,
  computed from the launch's shapes alone, so that they read the same work
  whatever implements the sweep;
- the trace readers: kernel launches counted on the host, the union of the
  kernels' device intervals (exact with several streams, where a sum of
  durations double-counts overlap), device time by kernel name, and the
  idle gaps labelled by the host operation running in each.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

# One H100 SXM, NVIDIA data sheet, dense, at the 700 W power limit.
H100_FP32_OPS_PER_S = 67e12
H100_BYTES_PER_S = 3.35e12

# FP32 operations of one watertight (ray, triangle) test whatever the data:
# 9 (v - o) + 12 shear + 9 barycentrics + 2 det + 6 scaled distance.  The
# division of a candidate that passes the edge test is left out, so a bound
# built on it is a floor.
OPS_PER_TRIANGLE_TEST = 38

# K1's device-side kernel name in the profiler's timeline.
K1_KERNEL = "best_key_kernel"

# The CUDA runtime's kernel-launch calls among the profiler's host events.
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def k1_work(n_rays: int, n_tris: int, exact: bool = True) -> Tuple[float, float]:
    """(FP32 operations, bytes) of one K1 launch over ``n_rays`` rays and
    ``n_tris`` triangles: 38 operations per (ray, triangle) test; each input
    read once (six f32 ray components and the i32 ignore id per ray, nine
    f32 vertex coordinates and the i32 primitive id per triangle) and each
    output written once (an i64 key per ray with ``exact``, else i32)."""
    ops = float(OPS_PER_TRIANGLE_TEST) * n_rays * n_tris
    bytes_in = n_rays * (6 * 4 + 4) + n_tris * (9 * 4 + 4)
    bytes_out = n_rays * (8 if exact else 4)
    return ops, float(bytes_in + bytes_out)


def bound_s(ops: float, bytes_moved: float) -> float:
    """Least time the card could take: the larger of the operations over
    the FP32 peak and the bytes over the memory rate."""
    return max(ops / H100_FP32_OPS_PER_S, bytes_moved / H100_BYTES_PER_S)


@dataclasses.dataclass
class Trace:
    """What the readers need of one traced window, in microseconds on the
    profiler's clock.

    ``spans`` holds the benchmark's own spans by name (each a list of
    (start, end)); ``kernels`` the device kernels (name, start, end);
    ``host_ops`` the host operations (name, start, end) that label idle
    gaps; ``launches`` the host times of kernel-launch calls."""

    spans: Dict[str, List[Tuple[float, float]]]
    kernels: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    launches: List[float]

    def __post_init__(self):
        self.kernels = sorted(self.kernels, key=lambda k: k[1])
        self._starts = [k[1] for k in self.kernels]
        self._longest = max((k[2] - k[1] for k in self.kernels), default=0.0)

    def overlapping(self, lo: float, hi: float) -> List[Tuple[str, float, float]]:
        """Kernels that run for some time inside [lo, hi)."""
        j0 = bisect.bisect_left(self._starts, lo - self._longest)
        j1 = bisect.bisect_left(self._starts, hi)
        return [k for k in self.kernels[j0:j1] if k[2] > lo]

    def launches_in(self, span: str) -> int:
        return sum(_count_in(self.launches, s, e) for s, e in self.spans.get(span, []))

    def kernels_in(self, span: str, name: Optional[str] = None) -> List[Tuple[str, float, float]]:
        """Kernels that start inside one of the spans of that name (and
        whose name holds ``name``)."""
        out = []
        for s, e in self.spans.get(span, []):
            j0, j1 = bisect.bisect_left(self._starts, s), bisect.bisect_left(self._starts, e)
            out += [k for k in self.kernels[j0:j1] if name is None or name in k[0]]
        return out

    def nccl_us(self, span: str) -> List[float]:
        """For each span of that name, the device time of the NCCL kernels
        that start inside it."""
        out = []
        for s, e in self.spans.get(span, []):
            j0, j1 = bisect.bisect_left(self._starts, s), bisect.bisect_left(self._starts, e)
            out.append(sum(k2 - k1 for name, k1, k2 in self.kernels[j0:j1] if "nccl" in name.lower()))
        return out

    def busy_us(self, span: str) -> float:
        """The union of the kernels' device intervals inside the spans."""
        return sum(union_us([(max(k1, s), min(k2, e)) for _, k1, k2 in self.overlapping(s, e)])
                   for s, e in self.spans.get(span, []))

    def span_us(self, span: str) -> float:
        return sum(e - s for s, e in self.spans.get(span, []))


def _count_in(sorted_times: Sequence[float], lo: float, hi: float) -> int:
    return bisect.bisect_left(sorted_times, hi) - bisect.bisect_left(sorted_times, lo)


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(kernels: Sequence[Tuple[str, float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] in which no kernel ran."""
    gaps, t = [], lo
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if e <= t:
            continue
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [g for g in gaps if g[1] > g[0]]


def _host_labels(host_ops: Sequence[Tuple[str, float, float]], times: Sequence[float]) -> List[str]:
    """The innermost host operation running at each of the sorted ``times``:
    the latest-starting one whose interval holds it ("(no host op)" where
    none does).  One sweep with a heap of the operations begun so far: an
    operation that ended before a time has ended before every later one."""
    ops = sorted(host_ops, key=lambda o: o[1])
    heap: list = []
    labels, j = [], 0
    for t in times:
        while j < len(ops) and ops[j][1] <= t:
            heapq.heappush(heap, (-ops[j][1], j))
            j += 1
        while heap and ops[heap[0][1]][2] < t:
            heapq.heappop(heap)
        labels.append(ops[heap[0][1]][0] if heap else "(no host op)")
    return labels


def breakdown(trace: Trace, span: str, top: int = 10) -> dict:
    """Inside the spans named ``span``: the device operations that took
    most time (summed by kernel name) and the idle time summed by the host
    operation running in each gap, in seconds, each list at most ``top``
    long."""
    by_kernel: Dict[str, float] = {}
    gaps = []
    for lo, hi in trace.spans.get(span, []):
        inside = trace.overlapping(lo, hi)
        for name, s, e in inside:
            by_kernel[name] = by_kernel.get(name, 0.0) + (min(e, hi) - max(s, lo))
        gaps += idle_gaps(inside, lo, hi)
    gaps.sort()
    by_host: Dict[str, float] = {}
    for (s, e), label in zip(gaps, _host_labels(trace.host_ops, [0.5 * (s + e) for s, e in gaps])):
        by_host[label] = by_host.get(label, 0.0) + (e - s)

    def top_of(d):
        return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(by_kernel), "idle_gaps": top_of(by_host)}


# Host events that the profiler's own parse leaves out: its bookkeeping and
# the autograd engine's trivial queries (``torch.autograd.profiler_util``).
FILTERED_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter", "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr", "aten::_version"))


def trace_from_profiler(prof, span_names: Sequence[str]) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``: the
    benchmark's spans (``record_function`` names in ``span_names``), the
    device kernels, the host operations other than the CUDA runtime's
    calls, and the launch calls.  It reads the profiler's raw events, in
    nanoseconds on one clock, and not ``prof.events()``, whose tree of
    Python objects takes tens of seconds to build for a few steps of the
    eager integrator."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans: Dict[str, List[Tuple[float, float]]] = {n: [] for n in span_names}
    kernels, host_ops, launches = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in FILTERED_EVENTS or getattr(e, "is_hidden_event", lambda: False)():
            continue
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        dev = e.device_type()
        if name in spans:
            # a span's mirror on the device's timeline is no kernel
            if dev == cpu:
                spans[name].append((s, t))
        elif dev == cuda:
            # an annotation mirrored on the device's timeline ("nccl:all_reduce")
            # spans its kernels and is none itself
            if not e.is_user_annotation():
                kernels.append((name, s, t))
        elif name in LAUNCH_EVENTS:
            launches.append(s)
        elif not name.startswith("cuda"):
            host_ops.append((name, s, t))
    for v in spans.values():
        v.sort()
    launches.sort()
    return Trace(spans=spans, kernels=kernels, host_ops=host_ops, launches=launches)
