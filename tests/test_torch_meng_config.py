"""The benchmark's Meng 2015 configuration (``cornell-srgb-meng-512``) on the
port's normal path against the benchmark's plain reference, on the CPU.

The configuration file is run as the cell ``meng-train-2m`` runs it, shrunk
to 16x16 at depth 3 (two bounces): ``forward_backward_step`` of the port
against ``benchmark/reference/steps.loss_and_grads`` on the inputs and keys
the cell's train traffic draws from a seed, compared by the cell's own
numbers (``loss_gap``, ``grad_gap``) and limits.  Each seed runs twice: on
the scene's own texture, and with its texel words replaced, in both
programs alike, by seeded random sRGB words, which put lanes in the grid's
inner cells and in its boundary (fan) cells; the test sees both happen.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402
from benchmark.reference import colorimetry as ref_colorimetry  # noqa: E402
from benchmark.reference import config as ref_config  # noqa: E402
from benchmark.reference import scene_library as ref_scene_library  # noqa: E402
from benchmark.reference import steps as ref_steps  # noqa: E402
from simple_spectral_torch.config import RenderConfig  # noqa: E402
from simple_spectral_torch.render.trainstep import forward_backward_step  # noqa: E402
from simple_spectral_torch.scene.library import build_scene  # noqa: E402
from simple_spectral_torch.spectra import upsample_meng  # noqa: E402
from simple_spectral_torch.spectra.colorimetry import build_color_tables  # noqa: E402

CONFIG = os.path.join(ROOT, "benchmark", "configs", "cornell-srgb-meng-512.json")
TRAFFIC = os.path.join(ROOT, "benchmark", "traffic", "train-2m.json")
SHRINK = {"width": 16, "height": 16, "max_depth": 3}
SEEDS = (2**31 + 20, 2**31 + 2021)


def _load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def states():
    """(fields, traffic, the port's (cfg, tables, scene), the reference's)."""
    fields = dict(_load(CONFIG)["render"], **SHRINK)
    assert fields["mode"] == "meng" and fields["texel_format"] == "u32"
    cfg = RenderConfig(**fields)
    tables = build_color_tables(cfg, device="cpu")
    rcfg = ref_config.RenderConfig(**fields)
    rtables = ref_colorimetry.build_color_tables(rcfg, device="cpu")
    return (fields, _load(TRAFFIC), (cfg, tables, build_scene(cfg, tables, device="cpu")),
            (rcfg, rtables, ref_scene_library.build_scene(rcfg, rtables, device="cpu")))


def _random_words(seed: int, n: int) -> torch.Tensor:
    """n packed 0xRRGGBB sRGB words, uniform over the 2^24 colours."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 1 << 24, n).astype(np.int32))


def _cells_reached(tables, xyz) -> tuple:
    """(lanes in inner cells, lanes in boundary cells) among the grid walk's
    inputs ``xyz``, by the walk's own cell reads."""
    x, y, z = (torch.cat(v) for v in zip(*xyz))
    _, _, _, _, cell, valid, _ = upsample_meng._uv_position(tables.meng, x, y, z)
    inside, num = upsample_meng._cell_values(tables.meng, cell)[:2]
    on_grid = valid & (num > 0)
    return int((on_grid & (inside > 0)).sum()), int((on_grid & (inside == 0)).sum())


@pytest.mark.parametrize("texture", ["scene", "random"])
@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_the_reference(states, monkeypatch, seed, texture):
    fields, traffic, (cfg, tables, scene), (rcfg, rtables, rscene) = states
    if texture == "random":
        words = _random_words(seed, scene.texture.shape[0])
        scene = dataclasses.replace(scene, texture=words)
        rscene = dataclasses.replace(rscene, texture=words.clone())
    walked = []
    walk = upsample_meng.meng_cell_weights_soa

    def recording_walk(meng, x, y, z):
        walked.append((x, y, z))
        return walk(meng, x, y, z)

    monkeypatch.setattr(upsample_meng, "meng_cell_weights_soa", recording_walk)
    lanes = fields["width"] * fields["height"] * int(traffic["lanes_per_pixel"])
    spp = int(traffic["spp"])
    px, target = common.train_inputs(seed, fields["width"], fields["height"], lanes, "cpu")
    key = common.step_key(seed, 0)

    prog = forward_backward_step(scene, tables, cfg, key, px, target, spp)
    ref = ref_steps.loss_and_grads(rscene, rtables, rcfg, key, px, target, spp)
    loss_gap, grad_gap = common.train_gaps([prog], [ref])

    limits = traffic["limits"]
    assert loss_gap <= limits["loss_gap"] and grad_gap <= limits["grad_gap"], (loss_gap, grad_gap)
    assert len(walked) == cfg.max_depth - 1
    inner, fan = _cells_reached(tables, walked)
    if texture == "random":
        assert inner > 0 and fan > 0, (inner, fan)
    else:
        assert inner + fan > 0
