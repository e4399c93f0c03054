"""A later change adds a configuration, a traffic mix and a metric as new
files with new entries in ``BENCHMARK.json``; the harness finds each by its
name, and no file that is there changes."""

import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            if "__pycache__" not in base:
                p = os.path.join(base, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = digests(root)

    # the new files
    cfg = json.load(open(os.path.join(root, "benchmark/configs/cornell-srgb-mallett-512.json")))
    cfg.update(name="cornell-srgb-mallett-256", render=dict(cfg["render"], width=256, height=256))
    json.dump(cfg, open(os.path.join(root, "benchmark/configs/cornell-srgb-mallett-256.json"), "w"))
    traffic = json.load(open(os.path.join(root, "benchmark/traffic/train-262k.json")))
    json.dump(dict(traffic, lanes_per_pixel=4), open(os.path.join(root, "benchmark/traffic/train-4x.json"), "w"))
    with open(os.path.join(root, "benchmark/metrics/steps_traced.train.py"), "w") as f:
        f.write("from benchmark.common import STEP_SPAN\n\n\n"
                "def read(run):\n    return float(len(run.trace.spans[STEP_SPAN])) if run.trace else None\n")
    # the new entries (BENCHMARK.json is the one file edited)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "cornell-srgb-mallett-256", "source": "https://github.com/geometrian/simple-spectral",
                            "file": "benchmark/configs/cornell-srgb-mallett-256.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "mallett256-train-4x", "config": "cornell-srgb-mallett-256",
                              "traffic": "train-4x", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("mallett256-train-4x")
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                              "source": "program_span", "layer": "integrator host dispatch",
                              "moves": "train_mrays_s", "workloads": ["mallett256-train-4x"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))

    after = digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    w, config, traffic = harness.cell(harness.load_spec(root), "mallett256-train-4x", root)
    assert config["render"]["width"] == 256 and traffic["lanes_per_pixel"] == 4
    spec = harness.load_spec(root)
    assert [m["name"] for m in harness.cell_metrics(spec, "mallett256-train-4x", False)] == ["train_mrays_s", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics(spec, "mallett256-train-4x", True)] == ["steps_traced.train"]
    run = harness.run_cell("mallett256-train-4x", 7, 0.5, True, device="cpu", root=root,
                           shrink={"width": 8, "height": 8, "max_depth": 2})
    metrics = harness.read_metrics(spec, "mallett256-train-4x", run, True, root)
    assert metrics == {"steps_traced.train": {"value": float(traffic["trace_steps"]), "unit": "steps"}}
    assert run.facts["k1_rays"] == 8 * 8 * 4
    assert run.correct
