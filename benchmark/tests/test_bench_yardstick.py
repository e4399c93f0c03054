"""The frozen yardsticks on synthetic data: K1's count at T = 38 and T = 14,
the profiler readers (launches, the union of kernel intervals, device time
by name, idle gaps and their host labels) and the per-layer readers."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, yardstick  # noqa: E402
from benchmark.common import FORWARD_SPAN, PASS_SPAN, STEP_SPAN  # noqa: E402


@pytest.mark.parametrize("n_tris,ops,bytes_moved,bound_us", [
    # 38 x 262144 x T operations; 262144 x (28 + 8) + T x 40 bytes
    (38, 378535936.0, 9438704.0, 378535936.0 / 67e12 * 1e6),
    (14, 139460608.0, 9437744.0, 9437744.0 / 3.35e12 * 1e6),
])
def test_k1_work(n_tris, ops, bytes_moved, bound_us):
    got_ops, got_bytes = yardstick.k1_work(262144, n_tris)
    assert got_ops == ops and got_bytes == bytes_moved
    assert yardstick.bound_s(got_ops, got_bytes) * 1e6 == pytest.approx(bound_us, rel=1e-12)


def test_k1_bound_sides():
    """T = 38 is bound by operations (5.65 us), T = 14 by bytes (2.82 us)."""
    assert yardstick.bound_s(*yardstick.k1_work(262144, 38)) == pytest.approx(5.6498e-6, rel=1e-4)
    assert yardstick.bound_s(*yardstick.k1_work(262144, 14)) == pytest.approx(2.8172e-6, rel=1e-4)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26)]
    assert yardstick.union_us(iv) == 25
    kernels = [("k", s, e) for s, e in iv]
    assert yardstick.idle_gaps(kernels, -5, 40) == [(-5, 0), (15, 20), (30, 40)]


def test_host_labels_innermost():
    ops = [("a", 0, 10), ("b", 2, 5), ("c", 6, 7), ("d", 12, 20)]
    assert yardstick._host_labels(ops, [1, 3, 5.5, 6.5, 11, 15, 25]) == [
        "a", "b", "a", "c", "(no host op)", "d", "(no host op)"]


def synthetic_trace():
    """Two steps of 100 us and two forward-only steps of 50 us; a pass of
    100 us; kernels (K1 among them, an NCCL one in the second step) and
    launch calls inside."""
    spans = {STEP_SPAN: [(0, 100), (200, 300)], FORWARD_SPAN: [(400, 450), (500, 550)], PASS_SPAN: [(600, 700)]}
    kernels = [
        ("elementwise", 10, 30), ("best_key_kernel", 40, 50), ("elementwise", 45, 60),  # step 1: busy 40
        ("best_key_kernel", 210, 220), ("ncclDevKernel_AllReduce_Sum_f32", 250, 290),  # step 2: busy 50
        ("elementwise", 410, 420), ("elementwise", 510, 520),  # forward: busy 10 each
        ("best_key_kernel", 610, 640),  # pass: busy 30
    ]
    host_ops = [("aten::mul", 0, 35), ("aten::add", 60, 100), ("aten::sum", 200, 300), ("aten::x", 600, 700)]
    launches = [5, 9, 35, 41, 205, 240, 405, 505, 605]
    return yardstick.Trace(spans=spans, kernels=kernels, host_ops=host_ops, launches=launches)


def test_trace_readers():
    tr = synthetic_trace()
    assert tr.launches_in(STEP_SPAN) == 6
    assert tr.busy_us(STEP_SPAN) == 90
    assert tr.span_us(STEP_SPAN) == 200
    assert [k[0] for k in tr.kernels_in(STEP_SPAN, "best_key")] == ["best_key_kernel"] * 2
    bd = yardstick.breakdown(tr, STEP_SPAN)
    assert bd["device_ops"][0] == ["ncclDevKernel_AllReduce_Sum_f32", 40e-6]
    # idle: step 1 [0,10) mul, [30,40) mul, [60,100) add; step 2 [200,210) [220,250) [290,300) sum
    assert dict(bd["idle_gaps"]) == pytest.approx({"aten::mul": 20e-6, "aten::add": 40e-6, "aten::sum": 50e-6})


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_per_layer_readers():
    tr = synthetic_trace()
    train = harness.Run(kind="train", setup_s=1.0, trace=tr, untraced_call_s=80e-6,
                        facts={"k1_rays": 262144, "n_tris": 38})
    assert read("launches_per_step.train", train) == 3
    # busy 45 us a step against 80 us a step untraced
    assert read("device_idle.train", train) == pytest.approx(1 - 45 / 80)
    assert read("bwd_device_share.train", train) == pytest.approx(1 - 10 / 45)
    k1_mean_s = 10e-6
    assert read("k1_roofline.train", train) == pytest.approx(100 * 5.6498e-6 / k1_mean_s, rel=1e-4)
    for name in ("allreduce_ms.dp4", "launches_per_step.dp4", "device_idle.dp4"):
        assert read(name, train) is None, name  # one card
    train.device_count = 4
    assert tr.nccl_us(STEP_SPAN) == [0.0, 40.0]
    assert read("allreduce_ms.dp4", train) is None  # no least over the ranks taken
    train.facts["nccl_us_least_rank"] = [0.0, 0.0]
    assert read("allreduce_ms.dp4", train) is None  # no NCCL kernel (gloo)
    train.facts["nccl_us_least_rank"] = [30.0, 40.0, 500.0]
    assert read("allreduce_ms.dp4", train) == pytest.approx(0.040)
    assert read("launches_per_step.dp4", train) == 3
    assert read("device_idle.dp4", train) == pytest.approx(1 - 45 / 80)
    train.untraced_call_s = None
    assert read("device_idle.train", train) is None
    render = harness.Run(kind="render", setup_s=1.0, trace=tr, untraced_call_s=100e-6,
                         facts={"k1_rays": 262144, "n_tris": 14})
    assert read("launches_per_pass.render", render) == 1
    assert read("device_idle.render", render) == pytest.approx(0.7)
    assert read("k1_roofline.render", render) == pytest.approx(100 * 2.8172e-6 / 30e-6, rel=1e-4)
    assert read("launches_per_step.train", render) is None


def test_end_to_end_readers():
    run = harness.Run(kind="train", setup_s=12.5, window_s=10.0, step_s=[0.1 * i for i in range(1, 11)], rays=2e8)
    assert read("setup_s", run) == 12.5
    assert read("train_mrays_s", run) == pytest.approx(20.0)
    assert read("train_mrays_s.dp4", run) is None
    run.device_count = 4
    assert read("train_mrays_s.dp4", run) == pytest.approx(20.0)
    assert read("train_step_ms_p90", run) == pytest.approx(910.0)
    assert read("render_mrays_s", run) is None
    render = harness.Run(kind="render", setup_s=1.0, window_s=4.0, rays=8e7, step_s=[1.0] * 4)
    assert read("render_mrays_s", render) == pytest.approx(20.0)


def test_every_metric_has_a_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read), m["name"]


def test_trace_from_profiler_reads_raw_events():
    """The reader of a real (CPU-only) profile: the spans, the host
    operations inside them, none of the profiler's own bookkeeping."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with record_function(STEP_SPAN):
                torch.ones(16).mul(2.0).sum()
    tr = yardstick.trace_from_profiler(prof, (STEP_SPAN,))
    assert len(tr.spans[STEP_SPAN]) == 2
    assert all(e > s for s, e in tr.spans[STEP_SPAN])
    names = {n for n, _, _ in tr.host_ops}
    assert {"aten::ones", "aten::mul", "aten::sum"} <= names
    assert not names & yardstick.FILTERED_EVENTS
    (s0, e0), (s1, _) = tr.spans[STEP_SPAN]
    assert any(s0 <= s and e <= e0 for n, s, e in tr.host_ops if n == "aten::mul") and e0 <= s1
    assert tr.kernels == [] and tr.busy_us(STEP_SPAN) == 0.0
