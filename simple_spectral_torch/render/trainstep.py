"""Differentiable render step, forward + backward (PyTorch port of
``simple_spectral_tpu.render.trainstep``).

The unit the benchmark times: render a batch of pixel lanes, compare with a
target by mean squared error, and backpropagate to the material tables (the
renderer's differentiable leaves, ``DIFF_FIELDS``).  The gradient flows only
through the shading phase of ``trace_lanes``; its geometry phase runs under
``no_grad``, so the closest-hit kernel needs no backward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.convert import DIFF_FIELDS
from simple_spectral_torch.render.integrator import trace_lanes
from simple_spectral_torch.scene.types import SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables
from simple_spectral_torch.utils.profiling import span

REMATS = ("none", "trace")


def material_params(scene: SceneData) -> dict:
    """The differentiable material leaves as a flat dict."""
    return {f: getattr(scene.materials, f) for f in DIFF_FIELDS}


def with_material_params(scene: SceneData, params: dict) -> SceneData:
    mats = dataclasses.replace(scene.materials, **params)
    return dataclasses.replace(scene, materials=mats)


def _loss_fn(scene: SceneData, tables: ColorTables, cfg: RenderConfig, key, px_flat: torch.Tensor,
             target: torch.Tensor, spp: int, remat: str):
    """mean((render(px) - target)^2) as a function of the material params.

    ``remat`` selects the memory/recompute trade of each sample's trace:
    "none" keeps the shading intermediates for the backward; "trace" wraps
    each sample's ``trace_lanes`` in ``torch.utils.checkpoint``, so the
    backward re-runs that sample's trace.  The spp samples run as an
    unrolled loop over ``rnd.split(key, spp)``, as in the JAX package."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    px_i = px_flat % cfg.width
    px_j = px_flat // cfg.width

    def sample_value(params, k):
        return trace_lanes(with_material_params(scene, params), tables, cfg, k, px_i, px_j).value

    def loss(params):
        keys = rnd.split(key, spp)
        sum_v = torch.zeros((px_flat.shape[0], 3), dtype=torch.float32, device=px_flat.device)
        for i in range(spp):
            if remat == "trace":
                value = checkpoint(sample_value, params, keys[i], use_reentrant=False)
            else:
                value = sample_value(params, keys[i])
            sum_v = sum_v + value
        mean_v = sum_v / spp
        return torch.mean((mean_v - target) ** 2)

    return loss


def _leaf_params(scene: SceneData) -> dict:
    return {f: t.detach().clone().requires_grad_(True) for f, t in material_params(scene).items()}


def forward_backward_step(scene: SceneData, tables: ColorTables, cfg: RenderConfig, key, px_flat: torch.Tensor,
                          target: torch.Tensor, spp: int, remat: str = "none"):
    """(loss, grads) = d/d(materials) mean((render(px) - target)^2).

    px_flat: i32[P]; target: f32[P, 3]; spp samples per pixel, averaged.
    ``grads`` holds every field of ``DIFF_FIELDS``; a table the mode does not
    read (``albedo_rgb`` and ``emission_rgb`` under mallett) gets zeros of
    its shape, as ``jax.value_and_grad`` returns."""
    params = _leaf_params(scene)
    with torch.enable_grad():
        loss = _loss_fn(scene, tables, cfg, key, px_flat, target, spp, remat)(params)
        with span("ss.backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {f: torch.zeros_like(p) if g is None else g for (f, p), g in zip(params.items(), grads)}
    return loss.detach(), grads


def forward_only_step(scene: SceneData, tables: ColorTables, cfg: RenderConfig, key, px_flat: torch.Tensor,
                      target: torch.Tensor, spp: int, remat: str = "none") -> torch.Tensor:
    """The same loss without gradients: the forward half of the step."""
    with torch.no_grad():
        return _loss_fn(scene, tables, cfg, key, px_flat, target, spp, remat)(material_params(scene))
