"""The cell ``meng-train-2m``: its entries in ``BENCHMARK.json``, the Meng
albedo's frozen floor (``benchmark/meng_work.py``), and the two metrics that
read the program's ``ss.meng`` span, on a hand-built trace and on a CPU
traced run of the cell at 8x8, depth 3."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, meng_work, program_spans, yardstick  # noqa: E402
from benchmark.common import STEP_SPAN  # noqa: E402
from benchmark.tests.test_bench_isolation import FORBIDDEN, imported_tops  # noqa: E402

CELL = "meng-train-2m"
METRICS = ("meng_device_share.train", "meng_roofline.train")


def reading(name, run):
    return harness.load_module("metrics", name).read(run)


def test_the_cell_and_its_configuration_are_declared():
    spec = harness.load_spec()
    (w,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("cornell-srgb-meng-512", "train-2m", 1)
    (c,) = [c for c in spec["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == [] and c["file"] == "benchmark/configs/cornell-srgb-meng-512.json"
    with open(os.path.join(ROOT, c["file"])) as f:
        config = json.load(f)
    assert config["reduced"] == [] and config["precision"] == "float32"
    assert config["render"] == {"scene": "cornell-srgb", "width": 512, "height": 512, "mode": "meng",
                                "observer": 1931, "n_wavelengths": 4, "max_depth": 10, "els": True,
                                "intersect_impl": "auto", "texel_format": "u32"}
    (rate,) = [m for m in spec["end_to_end"] if m["name"] == "train_mrays_s"]
    assert CELL in rate["workloads"] and rate["bound"] == 0.15
    assert [m["name"] for m in harness.cell_metrics(spec, CELL, False)] == ["train_mrays_s", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics(spec, CELL, True)] == list(METRICS)
    for m in harness.cell_metrics(spec, CELL, True):
        assert (m["layer"], m["moves"], m["workloads"]) == ("Meng upsampling", "train_mrays_s", [CELL])


def test_floor_at_the_cell_size():
    """2,097,152 lanes, 9 bounces, 4 hero wavelengths: 385,949,696 bytes
    (about 115 us at 3.35 TB/s, bandwidth-bound) and 1,132,462,080 FP32
    operations a step."""
    assert meng_work.config_shape() == (9, 4)
    assert meng_work.table_bytes() == 4 * (186 * 81 + 168 * 20 + 6) == 73_728
    ops, bytes_moved = meng_work.meng_work(2_097_152, 9, 4)
    assert ops == 1_132_462_080.0
    assert bytes_moved == 2_097_152 * 4 + 9 * 2_097_152 * 20 + 73_728 == 385_949_696.0
    assert yardstick.bound_s(ops, bytes_moved) == bytes_moved / yardstick.H100_BYTES_PER_S
    assert yardstick.bound_s(ops, bytes_moved) == pytest.approx(115.2089e-6, rel=1e-6)


def step_trace(meng_spans=True):
    """Two steps of 100 us.  Step 1: shading [10, 60) holding two meng
    spans [15, 30) and [35, 50), three kernels launched in them (10, 10
    and 4 us), one in shading after them (4 us), one before (2 us), one in
    the backward (10 us), and a copy that no launch makes.  Step 2: one
    meng span with one kernel (20 us) and one kernel after it (2 us)."""
    host_ops = [(program_spans.SHADING, 10, 60), (program_spans.SHADING, 210, 260)]
    if meng_spans:
        host_ops += [(meng_work.MENG, 15, 30), (meng_work.MENG, 35, 50), (meng_work.MENG, 215, 240)]
    kernels = [("Memcpy HtoD (Pageable -> Device)", 3, 4), ("pre", 6, 8), ("walk", 21, 31), ("einsum", 31, 41),
               ("hero", 41, 45), ("estimator", 56, 60), ("backward", 70, 80), ("walk", 221, 241), ("loss", 251, 253)]
    return yardstick.Trace(spans={STEP_SPAN: [(0, 100), (200, 300)]}, kernels=kernels, host_ops=host_ops,
                           launches=[5, 20, 25, 40, 55, 70, 220, 250])


def test_readers_on_a_hand_built_trace():
    run = harness.Run(kind="train", setup_s=1.0, trace=step_trace(), facts={"k1_rays": 4096, "n_tris": 38})
    assert meng_work.device_us_per_step(run) == pytest.approx((10 + 10 + 4 + 20) / 2)
    assert reading("meng_device_share.train", run) == pytest.approx(44 / 62)
    floor_s = yardstick.bound_s(*meng_work.meng_work(4096, 9, 4))
    assert reading("meng_roofline.train", run) == pytest.approx(100 * floor_s / 22e-6)


def test_readers_without_the_span_or_the_kind():
    """A program without ``ss.meng`` (the parent of the span), a render, or
    no trace: nothing to read."""
    facts = {"k1_rays": 4096, "n_tris": 38}
    runs = [harness.Run(kind="train", setup_s=1.0, trace=step_trace(meng_spans=False), facts=facts),
            harness.Run(kind="render", setup_s=1.0, trace=step_trace(), facts=facts),
            harness.Run(kind="train", setup_s=1.0, facts=facts)]
    for run in runs:
        assert meng_work.device_us_per_step(run) is None
        assert [reading(n, run) for n in METRICS] == [None, None]


def test_traced_cpu_run_of_the_cell():
    """The CPU trace holds ``ss.meng`` twice a call (two bounces) and no
    kernel: both readings are None, and the run is correct."""
    run = harness.run_cell(CELL, 2**31 + 20, 0.5, True, device="cpu",
                           shrink={"width": 8, "height": 8, "max_depth": 3})
    calls = len(run.trace.spans[STEP_SPAN]) + len(run.trace.spans["bench.forward"])
    assert len(program_spans.intervals(run.trace, meng_work.MENG)) == 2 * calls
    assert harness.read_metrics(harness.load_spec(), CELL, run, True) == {}
    assert run.correct


def test_meng_work_imports_neither_the_port_nor_jax():
    paths = [os.path.join(ROOT, "benchmark", "meng_work.py")]
    paths += [os.path.join(ROOT, "benchmark", "metrics", f"{n}.py") for n in METRICS]
    for p in paths:
        assert not (FORBIDDEN | {"simple_spectral_torch"}) & set(imported_tops(p)), p
    code = ("import sys; from benchmark import harness, meng_work; "
            "[harness.load_module('metrics', n) for n in %r]; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'simple_spectral_torch'))" % (METRICS,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
