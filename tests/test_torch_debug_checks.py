"""``cfg.debug_checks`` in the port: the float checks of
``utils/float_checks.py`` around ``_render_chunk``, the counterpart of the
JAX package's checkify instrumentation.  The three behaviours of
tests/test_debug_checks.py, on the port alone (no JAX checkify here):

* a clean scene traces clean, and the checked chunk equals the unchecked
  one bit for bit (the dispatch mode only reads the ops' outputs);
* a NaN planted in the albedo table raises, naming the op and its place;
* a light collapsed to zero area stays finite under the checks.
"""

import dataclasses

import pytest
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.renderer import _render_chunk
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables
from simple_spectral_torch.utils.float_checks import FloatChecks


def _setup(**kw):
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=4, debug_checks=True, **kw)
    tables = build_color_tables(cfg, device="cpu")
    return cfg, build_scene(cfg, tables, device="cpu"), tables


def _chunk(cfg, scene, tables, n_px=16):
    return _render_chunk(scene, tables, cfg, rnd.PRNGKey(0), torch.arange(n_px, dtype=torch.int32), 2)


@pytest.mark.parametrize("mode", ["rgb", "mallett"])
def test_clean_scene_traces_clean(mode):
    cfg, scene, tables = _setup(scene="cornell-srgb", mode=mode)
    sum_v, sum_a = _chunk(cfg, scene, tables)
    assert torch.isfinite(sum_v).all()
    sum_v0, sum_a0 = _chunk(cfg.replace(debug_checks=False), scene, tables)
    assert torch.equal(sum_v, sum_v0) and torch.equal(sum_a, sum_a0)


def test_poisoned_material_raises_located_error():
    cfg, scene, tables = _setup(scene="cornell", mode="mallett")
    albedo = torch.full_like(scene.materials.albedo_values, float("nan"))
    bad = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, albedo_values=albedo))
    with pytest.raises(FloatingPointError, match=r"NaN generated by aten::\w+ at simple_spectral_torch/\S+:\d+"):
        _chunk(cfg, bad, tables)


def test_degenerate_triangle_is_guarded():
    cfg, scene, tables = _setup(scene="cornell", mode="rgb")
    tv = scene.tri_verts.clone()
    light = scene.light_tris.reshape(-1).to(torch.int64)
    tv[light] = tv[light][:, :1]  # all three vertices identical
    sum_v, _ = _chunk(cfg, dataclasses.replace(scene, tri_verts=tv), tables)
    assert torch.isfinite(sum_v).all()


def test_checks_follow_checkify():
    """NaN outputs of arithmetic raise whether or not an input held one;
    selects and min/max pass a NaN through unchecked; every zero divisor
    raises, float or integer, as do integer remainders by zero."""
    nan = torch.tensor([float("nan"), 1.0])
    with FloatChecks():
        torch.where(torch.tensor([False, True]), nan, 0.0)
        torch.maximum(nan, torch.zeros(2))
        torch.tensor([7, 8]) // torch.tensor([2, 3])
        torch.tensor([1.0, 2.0]) % 0.5
        for fn, what in ((lambda: nan + 1.0, "NaN generated by aten::add"),
                         (lambda: torch.sqrt(torch.tensor([-1.0])), "NaN generated by aten::sqrt"),
                         (lambda: torch.ones(2) / torch.tensor([1.0, 0.0]), "division by zero in aten::div"),
                         (lambda: torch.tensor([3]) % torch.tensor([0]), "division by zero in aten::remainder"),
                         (lambda: torch.ones(2).reciprocal_(), None)):
            if what is None:
                fn()
                continue
            with pytest.raises(FloatingPointError, match=what):
                fn()
