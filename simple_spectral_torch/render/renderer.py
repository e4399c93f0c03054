"""Render orchestration: lanes -> pixels -> image (PyTorch port of
``simple_spectral_tpu.render.renderer``).

The (pixels x spp) lane grid is chunked to bound device memory; each chunk
loops over its samples, and per-pixel means accumulate in float64 on the
host, as the reference accumulates per-pixel samples in f64 (reference
src/renderer.cpp:287-296).  Keys follow the JAX package: chunk c draws from
``fold_in(PRNGKey(seed), c)``, split once per sample.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.integrator import trace_lanes
from simple_spectral_torch.scene.types import SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables, ciexyz_to_srgb, lrgb_to_srgb
from simple_spectral_torch.utils.float_checks import FloatChecks


def render_chunk_lanes(cfg: RenderConfig, scene: SceneData) -> int:
    """Pixel-lane budget for one render chunk: the sample loop runs inside
    the chunk, so peak memory is O(lanes) whatever the sample count.  As in
    the JAX package, two cases cap at 2^18 lanes: scenes with cluster tiles
    (the cull's [C, N] slab stage grows with the cluster count), and the
    textured meng pipeline (each bounce's [P=186, N] point-weight tensor
    omega takes 195 MB at 2^18 lanes)."""
    lanes = cfg.max_lanes
    if scene.cull_tiles is not None:
        lanes = min(lanes, 1 << 18)
    if cfg.spectral and cfg.mode == "meng" and scene.texture is not None:
        lanes = min(lanes, 1 << 18)
    return max(1, lanes)


def _render_chunk(scene: SceneData, tables: ColorTables, cfg: RenderConfig, key, px_flat: torch.Tensor, spp: int):
    """Trace ``spp`` samples for each pixel in ``px_flat`` (i32[P]) and
    return (sum f32[P, 3], alpha_sum f32[P]) over the samples.  With
    ``cfg.debug_checks`` every aten op of the chunk is checked for NaN and
    division by zero (``utils/float_checks.py``), and the first failure
    raises ``FloatingPointError`` with its op and place."""
    with FloatChecks() if cfg.debug_checks else contextlib.nullcontext():
        p = px_flat.shape[0]
        px_i = px_flat % cfg.width
        px_j = px_flat // cfg.width
        keys = rnd.split(key, spp)
        sum_v = torch.zeros((p, 3), dtype=torch.float32, device=px_flat.device)
        sum_a = torch.zeros((p,), dtype=torch.float32, device=px_flat.device)
        for s in range(spp):
            res = trace_lanes(scene, tables, cfg, keys[s], px_i, px_j)
            sum_v = sum_v + res.value
            sum_a = sum_a + res.alpha
    return sum_v, sum_a


def render_accumulate(cfg: RenderConfig, scene: SceneData, tables: ColorTables, seed: int = 0,
                      progress: bool = False):
    """Monte-Carlo estimate of the per-pixel mean value (XYZ in spectral
    modes, lRGB flux in rgb mode) and hit-mask alpha, on the scene's device.

    Returns (value f64[H, W, 3], alpha f64[H, W]) as numpy, row 0 at the
    *bottom* of the image (reference src/framebuffer.hpp:23-26)."""
    device = scene.device
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_px = w * h
    px_per_chunk = max(1, min(n_px, render_chunk_lanes(cfg, scene)))
    key = rnd.PRNGKey(seed)

    value = np.zeros((n_px, 3), np.float64)
    alpha = np.zeros((n_px,), np.float64)
    t0 = time.time()
    n_chunks = (n_px + px_per_chunk - 1) // px_per_chunk
    with torch.no_grad():
        for c in range(n_chunks):
            lo = c * px_per_chunk
            hi = min(lo + px_per_chunk, n_px)
            px = torch.arange(lo, hi, dtype=torch.int32, device=device)
            sum_v, sum_a = _render_chunk(scene, tables, cfg, rnd.fold_in(key, c), px, spp)
            value[lo:hi] = sum_v.cpu().numpy().astype(np.float64) / spp
            alpha[lo:hi] = sum_a.cpu().numpy().astype(np.float64) / spp
            if progress:
                done = hi / n_px
                dt = time.time() - t0
                eta = dt / max(done, 1e-9) * (1.0 - done)
                print(f"\r{done * 100.0:6.2f}%  elapsed {dt:6.1f}s  ETA {eta:6.1f}s", end="", flush=True)
    if progress:
        print()
    return value.reshape(h, w, 3), alpha.reshape(h, w)


def finalize_srgb(cfg: RenderConfig, tables: ColorTables, value, alpha) -> np.ndarray:
    """Accumulated mean -> sRGB+alpha framebuffer (reference
    src/renderer.cpp:292-298).  Returns f32[H, W, 4], row 0 at the bottom."""
    v = torch.as_tensor(np.asarray(value, np.float32), device=tables.obs_values.device)
    srgb = ciexyz_to_srgb(tables, v, cfg.mode) if cfg.spectral else lrgb_to_srgb(v)
    srgb = srgb.cpu().numpy().astype(np.float32)
    return np.concatenate([srgb, np.asarray(alpha, np.float32)[..., None]], axis=-1)


def render_image(cfg: RenderConfig, scene: Optional[SceneData] = None, tables: Optional[ColorTables] = None,
                 seed: int = 0, progress: bool = False, device="cuda") -> np.ndarray:
    """Full pipeline on ``device``: build tables and scene if not given,
    trace, convert.  Returns sRGB+A f32[H, W, 4], row 0 at the bottom."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    device = resolve_device(device)
    if tables is None:
        tables = build_color_tables(cfg, device=device)
    if scene is None:
        scene = build_scene(cfg, tables, device=device)
    value, alpha = render_accumulate(cfg, scene, tables, seed=seed, progress=progress)
    return finalize_srgb(cfg, tables, value, alpha)
