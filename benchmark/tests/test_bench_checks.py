"""The check that decides ``correct``, driven end to end on the CPU at 8x8
pixels and depth 3: sound runs come out correct, every fault of
``faults.py`` that a cell can have comes out not correct, the control reads
above the limits, a two-rank gloo world prints one line from rank 0 and a
failing rank fails the run."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DRIVE = os.path.join(ROOT, "benchmark", "tests", "drive.py")
SEED = 2147483901

# the faults each cell can have
CELL_FAULTS = [
    ("mallett-train-2m", None, ("unchanged", "half", "altered")),
    ("jakob-render-64spp", None, ("unchanged", "half", "altered")),
    ("mallett-train-dp4", 2, ("unchanged", "half", "altered", "no_exchange")),
]

SITECUSTOMIZE = textwrap.dedent(f"""
    import os, sys
    if os.environ.get("BENCH_TEST_FAULT"):
        sys.path.insert(0, {ROOT!r})
        from benchmark.tests import faults
        faults.plant(os.environ["BENCH_TEST_FAULT"])
    rank = os.environ.get("BENCH_TEST_FAIL_RANK")
    if rank and len(sys.argv) > 1 and f'"rank": {{rank}},' in sys.argv[-1]:
        sys.stderr.write(f"planted failure of rank {{rank}}\\n")
        sys.exit(3)
""")


def drive(tmp_path, workload, world=None, fault=None, fail_rank=None, trace=0, card=False, seed=SEED):
    (tmp_path / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    env.pop("BENCH_TEST_FAULT", None)
    if fault:
        env["BENCH_TEST_FAULT"] = fault
    if fail_rank is not None:
        env["BENCH_TEST_FAIL_RANK"] = str(fail_rank)
    argv = [sys.executable, DRIVE, "--workload", workload, "--seed", str(seed), "--trace", str(trace)]
    if world:
        argv += ["--world", str(world)]
    if card:
        argv += ["--device", "cuda", "--full", "--seconds", "3"]
    return subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,world", [(w, n) for w, n, _ in CELL_FAULTS])
def test_sound_run_is_correct(tmp_path, workload, world):
    line = last_line(drive(tmp_path, workload, world))
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("workload,world,fault", [(w, n, f) for w, n, fs in CELL_FAULTS for f in fs])
def test_planted_fault_is_not_correct(tmp_path, workload, world, fault):
    line = last_line(drive(tmp_path, workload, world, fault=fault))
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload,world,fault", [(w, n, f) for w, n, fs in CELL_FAULTS for f in fs])
def test_planted_fault_is_not_correct_on_the_card(tmp_path, workload, world, fault):
    """Each fault at the cell's own size on the card (3 seeds; the
    sharded cell on as many cards as it asks for)."""
    import torch

    sys.path.insert(0, ROOT)
    from benchmark import harness

    w, _, _ = harness.cell(harness.load_spec(), workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        pytest.skip(f"needs {w['chips']} CUDA device(s): the faults at the cell's size run on the card")
    for seed in (SEED, SEED + 1, SEED + 2):
        line = last_line(drive(tmp_path, workload, fault=fault, card=True, seed=seed))
        assert line["correct"] is False, (fault, seed, line["checks"])


def test_two_ranks_print_one_line(tmp_path):
    proc = drive(tmp_path, "mallett-train-dp4", world=2)
    line = last_line(proc)
    assert line["device"]["count"] == 2
    json_lines = [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert len(json_lines) == 1
    assert "[rank 1]" in proc.stderr


def test_rank_cards_follow_the_visible_list(monkeypatch):
    sys.path.insert(0, ROOT)
    from benchmark import launch

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert [launch.card_of(r) for r in range(4)] == ["0", "1", "2", "3"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5, 6,7")
    assert [launch.card_of(r) for r in range(4)] == ["4", "5", "6", "7"]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2")
    with pytest.raises(RuntimeError):
        launch.card_of(1)


def test_rank_holding_a_forbidden_module_fails_the_run(tmp_path):
    """A rank other than 0 that holds a JAX module once its steps are done
    fails, and so fails the run."""
    (tmp_path / "jax.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\nif len(sys.argv) > 1 and '\"rank\": 1,' in sys.argv[-1]:\n    import jax\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, DRIVE, "--workload", "mallett-train-dp4", "--seed", str(SEED),
                           "--world", "2"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "rank 1 holds forbidden modules ['jax']" in proc.stderr


def test_failing_rank_fails_the_run(tmp_path):
    proc = drive(tmp_path, "mallett-train-dp4", world=2, fail_rank=1)
    assert proc.returncode != 0
    assert not [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert "planted failure of rank 1" in proc.stderr


@pytest.mark.parametrize("workload,world", [(w, n) for w, n, _ in CELL_FAULTS])
def test_control_fails_the_limits(workload, world):
    """The reference in bfloat16 shading, in the program's place, reads
    above a limit of the cell's."""
    sys.path.insert(0, ROOT)
    from benchmark import control, harness

    ctx = harness.context(workload, SEED, 0.0, False, device="cpu", shrink={"width": 8, "height": 8, "max_depth": 3},
                          world=world)
    gaps = control.control_gaps(ctx)
    assert any(v > ctx.traffic["limits"][k] for k, v in gaps.items()), gaps


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w for w, _, _ in CELL_FAULTS])
def test_control_fails_the_limits_on_the_card(workload):
    """The control at the cell's own size on the card (3 seeds)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size runs on the card")
    sys.path.insert(0, ROOT)
    from benchmark import control, harness

    for seed in (SEED, SEED + 1, SEED + 2):
        ctx = harness.context(workload, seed, 0.0, False)
        gaps = control.control_gaps(ctx)
        assert any(v > ctx.traffic["limits"][k] for k, v in gaps.items()), gaps
