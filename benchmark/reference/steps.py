"""The steps that the benchmark's cells time, computed by the reference.

Each function derives its keys exactly as the program's entry does, so that
one seed gives both sides the same sample streams:

- :func:`loss_and_grads`: ``forward_backward_step``'s loss
  ``mean((mean over spp of value - target)^2)`` and its gradients with
  respect to the four material tables;
- :func:`image_sums`: the per-pixel sums of a progressive render's passes,
  pass p on ``fold_in(PRNGKey(seed), 1 + spp done)``, chunk c on
  ``fold_in(pass key, c)``, each sample on a key split from it;
- :func:`shard_loss_and_grads`: one dp shard's part of the sharded train
  step, on ``fold_in(fold_in(key, di), 0)``; the shards' parts add up to the
  mesh's loss and gradients.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import rng
from benchmark.reference.integrator import trace_lanes

# the material tables the train step differentiates, in the program's order
DIFF_FIELDS = ("albedo_values", "emission_values", "albedo_rgb", "emission_rgb")


def _with_params(scene, params: dict):
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **params))


def _sample_sum(scene, tables, cfg, key, px: torch.Tensor, spp: int, shade_dtype) -> torch.Tensor:
    """Sum over ``spp`` samples of each lane's value, f32[P, 3]; sample i on
    ``split(key, spp)[i]``."""
    px_i, px_j = px % cfg.width, px // cfg.width
    total = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    for k in rng.split(key, spp):
        total = total + trace_lanes(scene, tables, cfg, k, px_i, px_j, shade_dtype).value
    return total


def _grads(loss, params: dict) -> dict:
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {f: torch.zeros_like(p) if g is None else g.detach() for (f, p), g in zip(params.items(), grads)}


def loss_and_grads(scene, tables, cfg, key, px: torch.Tensor, target: torch.Tensor, spp: int,
                   shade_dtype=torch.float32):
    """(loss f32 scalar, {field: gradient}) of one train step."""
    params = {f: getattr(scene.materials, f).detach().clone().requires_grad_(True) for f in DIFF_FIELDS}
    with torch.enable_grad():
        mean_v = _sample_sum(_with_params(scene, params), tables, cfg, key, px, spp, shade_dtype) / spp
        loss = torch.mean((mean_v - target) ** 2)
        grads = _grads(loss, params)
    return loss.detach(), grads


def shard_loss_and_grads(scene, tables, cfg, key, di: int, px: torch.Tensor, target: torch.Tensor, spp: int,
                         n_total: int, shade_dtype=torch.float32):
    """Shard di's part of the sharded step: ``sum((mean_v - target)^2) /
    (3 n_total)`` over its lanes ``px`` and its gradients."""
    params = {f: getattr(scene.materials, f).detach().clone().requires_grad_(True) for f in DIFF_FIELDS}
    kshard = rng.fold_in(rng.fold_in(key, di), 0)
    with torch.enable_grad():
        mean_v = _sample_sum(_with_params(scene, params), tables, cfg, kshard, px, spp, shade_dtype) / spp
        loss = torch.sum((mean_v - target) ** 2) / (3.0 * n_total)
        grads = _grads(loss, params)
    return loss.detach(), grads


def image_sums(scene, tables, cfg, seed: int, pass_spp: int, n_passes: int, shade_dtype=torch.float32):
    """(value sums f64[P, 3], alpha sums f64[P]) of ``n_passes`` passes of
    ``pass_spp`` samples, each pass's f32 sums added in float64 as the
    progressive renderer's host accumulator adds them."""
    n_px = cfg.width * cfg.height
    chunk = max(1, min(n_px, cfg.max_lanes))
    dev = scene.device
    sum_v = np.zeros((n_px, 3), np.float64)
    sum_a = np.zeros((n_px,), np.float64)
    with torch.no_grad():
        for p in range(n_passes):
            key = rng.fold_in(rng.PRNGKey(seed), 1 + p * pass_spp)
            for c in range((n_px + chunk - 1) // chunk):
                lo, hi = c * chunk, min((c + 1) * chunk, n_px)
                px = torch.arange(lo, hi, dtype=torch.int32, device=dev)
                px_i, px_j = px % cfg.width, px // cfg.width
                v = torch.zeros((hi - lo, 3), dtype=torch.float32, device=dev)
                a = torch.zeros((hi - lo,), dtype=torch.float32, device=dev)
                for k in rng.split(rng.fold_in(key, c), pass_spp):
                    res = trace_lanes(scene, tables, cfg, k, px_i, px_j, shade_dtype)
                    v = v + res.value
                    a = a + res.alpha
                sum_v[lo:hi] += v.cpu().numpy().astype(np.float64)
                sum_a[lo:hi] += a.cpu().numpy().astype(np.float64)
    return sum_v, sum_a
