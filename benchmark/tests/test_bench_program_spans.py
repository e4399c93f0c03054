"""The readers of the program's own spans (``benchmark/program_spans.py``)
on hand-built traces, then the seven metrics that read them from a CPU
traced run of each one-chip cell at 8x8, depth 3."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, program_spans, yardstick  # noqa: E402
from benchmark.common import PASS_SPAN, STEP_SPAN  # noqa: E402
from benchmark.program_spans import BACKWARD, INTERSECT, RNG, SHADING  # noqa: E402

TRAIN_METRICS = ("rng_device_share.train", "intersect_device_share.train", "shading_device_share.train",
                 "backward_device_share.train")
RENDER_METRICS = ("rng_idle_share.render", "readback_ms.render", "host_add_ms.render")


def step_trace(kernels=None, launches=None):
    """Two steps of 100 us.  Step 1: an rng span [0, 20) holding a nested
    one, a sweep [20, 30), shading [30, 60), the backward [60, 90); its
    kernels run late, in launch order, after a copy.  Step 2: one rng
    launch and one unlabelled launch."""
    spans = {STEP_SPAN: [(0, 100), (200, 300)]}
    host_ops = [(RNG, 0, 20), (RNG, 5, 10), ("aten::add", 6, 8), (INTERSECT, 20, 30), (SHADING, 30, 60),
                (BACKWARD, 60, 90), (RNG, 200, 210)]
    if launches is None:
        launches = [2, 7, 25, 40, 70, 75, 205, 250]
    if kernels is None:
        kernels = [("Memcpy HtoD (Pageable -> Device)", 3, 4),
                   ("threefry_and", 10, 14), ("threefry_xor", 14, 16), ("best_key_kernel", 26, 36),
                   ("mul", 45, 60), ("mul_backward", 72, 82), ("sum", 82, 84),
                   ("Memset (Device)", 201, 202), ("threefry_add", 206, 212), ("loss", 260, 262)]
    return yardstick.Trace(spans=spans, kernels=kernels, host_ops=host_ops, launches=launches)


def train_run(trace):
    return harness.Run(kind="train", setup_s=1.0, trace=trace)


def test_pairing_in_launch_order():
    pairs = program_spans.matched_kernels(step_trace(), STEP_SPAN)
    assert [[(t, k[0]) for t, k in call] for call in pairs] == [
        [(2, "threefry_and"), (7, "threefry_xor"), (25, "best_key_kernel"), (40, "mul"), (70, "mul_backward"),
         (75, "sum")],
        [(205, "threefry_add"), (250, "loss")]]


def test_pairing_keeps_a_kernel_ahead_of_its_call():
    """The profiler's clock may put a call's first kernel a little before
    the call's span: it stays paired with its launch."""
    tr = step_trace()
    tr = yardstick.Trace(spans=tr.spans, host_ops=tr.host_ops, launches=tr.launches,
                         kernels=[k if k[0] != "threefry_add" else ("threefry_add", 199, 205) for k in tr.kernels])
    pairs = program_spans.matched_kernels(tr, STEP_SPAN)
    assert [(t, k[0]) for t, k in pairs[1]] == [(205, "threefry_add"), (250, "loss")]


def test_count_mismatch_reads_none():
    tr = step_trace(launches=[2, 7, 25, 40, 70, 205, 250])
    assert program_spans.matched_kernels(tr, STEP_SPAN) is None
    assert program_spans.device_share(train_run(tr), "train", STEP_SPAN, RNG) is None


def test_copies_and_fills_left_out():
    tr = step_trace()
    kernels = [k for call in program_spans.matched_kernels(tr, STEP_SPAN) for _, k in call]
    assert not [k for k in kernels if k[0].startswith(("Memcpy", "Memset"))]
    # 4 + 2 + 6 of 4 + 2 + 10 + 15 + 10 + 2 + 6 + 2 = 51 device us
    assert program_spans.device_share(train_run(tr), "train", STEP_SPAN, RNG) == pytest.approx(12 / 51)


def test_disjoint_shares_and_remainder_sum_to_one():
    tr = step_trace()
    run = train_run(tr)
    shares = {n: program_spans.device_share(run, "train", STEP_SPAN, n) for n in (RNG, INTERSECT, SHADING, BACKWARD)}
    assert shares == pytest.approx({RNG: 12 / 51, INTERSECT: 10 / 51, SHADING: 15 / 51, BACKWARD: 12 / 51})
    spans = [program_spans.intervals(tr, n) for n in shares]
    pairs = [p for call in program_spans.matched_kernels(tr, STEP_SPAN) for p in call]
    rest = sum(k[2] - k[1] for t, k in pairs if not any(s <= t < e for iv in spans for s, e in iv))
    assert rest == 2
    assert sum(shares.values()) + rest / 51 == pytest.approx(1.0, abs=1e-12)


def test_idle_gap_split_across_spans():
    """A pass of 100 us with one kernel [40, 50): its gaps [0, 40) and
    [50, 100) are split by the rng spans [30, 45) and [90, 120), whatever
    the gaps' midpoints."""
    tr = yardstick.Trace(spans={PASS_SPAN: [(0, 100)]}, kernels=[("k", 40, 50)],
                         host_ops=[(RNG, 30, 45), (RNG, 90, 120), ("ss.readback", 95, 99)], launches=[35])
    run = harness.Run(kind="render", setup_s=1.0, trace=tr)
    assert program_spans.idle_share(run, "render", PASS_SPAN, RNG) == pytest.approx((10 + 10) / 90)
    assert program_spans.host_ms(run, "render", PASS_SPAN, "ss.readback") == pytest.approx(0.004)
    assert program_spans.host_ms(run, "render", PASS_SPAN, RNG) == pytest.approx(0.025)
    assert program_spans.idle_share(run, "train", PASS_SPAN, RNG) is None
    # a program without the span reads None, not 0
    assert program_spans.host_ms(run, "render", PASS_SPAN, "ss.host_add") is None


@pytest.mark.parametrize("workload,numbers,nones", [
    ("jakob-render-64spp", RENDER_METRICS, TRAIN_METRICS),
    ("mallett-train-2m", (), TRAIN_METRICS + RENDER_METRICS),
])
def test_traced_cpu_run_reads_the_metrics(workload, numbers, nones):
    """A CPU trace holds the spans and no kernel: the render's three
    readings are numbers, each train share None (nothing to pair)."""
    run = harness.run_cell(workload, 2**31 + 11, 0.5, True, device="cpu",
                           shrink={"width": 8, "height": 8, "max_depth": 3})
    spec = harness.load_spec()
    metrics = harness.read_metrics(spec, workload, run, True)
    print(workload, {n: program_spans_reading(n, run) for n in TRAIN_METRICS + RENDER_METRICS})
    for n in numbers:
        assert metrics[n]["value"] >= 0.0, n
    for n in nones:
        assert program_spans_reading(n, run) is None, n
    assert run.correct


def program_spans_reading(name, run):
    return harness.load_module("metrics", name).read(run)
