"""The port's ``ss.*`` profiler spans (``utils.profiling.span``) on the CPU:
free of the profiler when none runs, opened where the benchmark's readers
expect them, and without effect on what the program computes.

One mallett train step at 8x8, depth 3 with explicit light sampling (two
bounces, each a bounce and a shadow sweep), one meng train step of the same
shape (its ``ss.meng`` span, once per bounce) and one progressive pass at
the same size, on the cornell-srgb scene.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.progressive import ProgressiveRenderer
from simple_spectral_torch.render.trainstep import forward_backward_step
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables
from simple_spectral_torch.utils.profiling import span

KW = dict(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=1, max_depth=3, els=True)
SPANS = ("ss.rng", "ss.intersect", "ss.shading", "ss.meng", "ss.backward", "ss.readback", "ss.host_add")


def _setup(kw):
    cfg = RenderConfig(**kw)
    tables = build_color_tables(cfg, device="cpu")
    scene = build_scene(cfg, tables, device="cpu")
    px = torch.arange(cfg.width * cfg.height, dtype=torch.int32)
    target = torch.rand((px.shape[0], 3), generator=torch.Generator().manual_seed(3))
    return cfg, tables, scene, px, target


@pytest.fixture(scope="module")
def setup():
    return _setup(KW)


@pytest.fixture(scope="module")
def meng_setup():
    return _setup(dict(KW, mode="meng"))


def _step(setup):
    cfg, tables, scene, px, target = setup
    return forward_backward_step(scene, tables, cfg, rnd.PRNGKey(5), px, target, 1)


def _spans(prof) -> dict:
    """Host intervals (start, end) in ns of each ``ss.*`` span."""
    out = {n: [] for n in SPANS}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out and e.device_type() == torch.autograd.DeviceType.CPU:
            out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _profiled(setup):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, grads = _step(setup)
    return loss, grads, _spans(prof)


@pytest.fixture(scope="module")
def profiled_step(setup):
    return _profiled(setup)


@pytest.fixture(scope="module")
def meng_profiled_step(meng_setup):
    return _profiled(meng_setup)


def test_span_without_profiler_is_one_null_context():
    assert span("ss.rng") is span("ss.shading")
    assert isinstance(span("ss.rng"), contextlib.nullcontext)


def test_train_step_spans(profiled_step):
    spans = profiled_step[2]
    assert len(spans["ss.intersect"]) == 4
    assert len(spans["ss.shading"]) == 1
    assert len(spans["ss.backward"]) == 1
    assert spans["ss.rng"]
    assert not spans["ss.readback"] and not spans["ss.host_add"]
    others = spans["ss.shading"] + spans["ss.backward"]
    assert not [(r, o) for r in spans["ss.rng"] for o in others if r[0] < o[1] and o[0] < r[1]]


def test_pass_spans(setup):
    cfg, tables, scene = setup[:3]
    pr = ProgressiveRenderer(cfg, scene, tables, seed=2, spp_per_pass=1, native=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pr.run_pass()
    spans = _spans(prof)
    assert len(spans["ss.readback"]) == 1 and len(spans["ss.host_add"]) == 1
    assert len(spans["ss.shading"]) == 1


def test_spans_change_no_result(setup, profiled_step):
    loss, grads, _ = profiled_step
    loss0, grads0 = _step(setup)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    assert all(torch.equal(grads[f], grads0[f]) for f in grads)


def test_meng_span_once_per_bounce_inside_shading(meng_setup, meng_profiled_step):
    spans = meng_profiled_step[2]
    assert len(spans["ss.meng"]) == meng_setup[0].max_depth - 1 == 2
    (shading,) = spans["ss.shading"]
    assert all(shading[0] <= s and e <= shading[1] for s, e in spans["ss.meng"])


def test_mallett_step_opens_no_meng_span(profiled_step):
    assert profiled_step[2]["ss.shading"] and not profiled_step[2]["ss.meng"]


def test_meng_span_changes_no_result(meng_setup, meng_profiled_step):
    loss, grads, _ = meng_profiled_step
    loss0, grads0 = _step(meng_setup)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    assert all(torch.equal(grads[f], grads0[f]) for f in grads)
