"""The inputs at which K2 and gather_u32 are timed against other builds of
them (``ab_render --kernel``, ``tools.kernel_variants``).

Only interfaces that every checkout of the port since the scale path has
are used here, so that ``ab_render`` can load this file from one checkout
and build the same inputs with another checkout's package.  Nothing here
touches a card when it is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def k2_bounce_sweep(device, sort: bool = True, seed: int = 7) -> dict:
    """One bounce sweep of cornell-stress (profile_render's configuration,
    512x512: 5000 boxes, 250 spheres, 1205 clusters) as K2 takes it: 262144
    rays leaving the camera hits in seeded random directions, ignoring the
    primitive they leave, in Morton order when ``sort``, through stage 2.
    Returns the keyword arguments of ``cull.cull_best_cuda``."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.profile_render import CONFIGS
    from simple_spectral_torch.render import cull
    from simple_spectral_torch.render.integrator import camera_rays_soa
    from simple_spectral_torch.render.intersect import intersect_rays_dispatch
    from simple_spectral_torch.render.vec import V3
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = RenderConfig(width=512, height=512, **CONFIGS["cornell-stress"])
    scene = build_scene(cfg, build_color_tables(cfg, device=device), device=device)
    n = cfg.width * cfg.height
    px = (torch.arange(n, dtype=torch.int64, device=device) * 7919 % n).to(torch.int32)
    co, cd = camera_rays_soa(scene, cfg, rnd.PRNGKey(1), px % cfg.width, px // cfg.width)
    co = V3(*(c.contiguous() for c in co))
    rec = intersect_rays_dispatch(scene, co, cd, torch.full((n,), -1, dtype=torch.int32, device=device), cfg.eps)
    o = co + cd * torch.where(torch.isfinite(rec.dist), rec.dist, 0.0)
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d = V3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])).to(device) for i in range(3)))
    ign = rec.prim
    if sort:
        order = cull.morton_order(scene.cull_tiles, o, d)
        o, d, ign = V3(*(c[order] for c in o)), V3(*(c[order] for c in d)), ign[order]
    rays = cull.cull_rays(o, d, ign)
    counts, lists, entries = cull.cull_lists(scene.cull_tiles, rays, cfg.eps)
    return {"tiles": scene.cull_tiles, "counts": counts, "lists": lists, "entries": entries, "rays": rays,
            "n_valid": n, "eps": cfg.eps}


def texel_gather(device) -> dict:
    """The texel gather of one cornell-srgb sample (mallett, 512x512, depth
    10) as gather_u32 takes it: the texture words and the real merged
    texel-fetch indices, a flat take.  Returns the keyword arguments of
    ``bench_gather.gather_u32_cuda``."""
    from simple_spectral_torch.tools import bench_gather

    table, idx = bench_gather.texel_indices(device)
    return {"table": table, "idx": idx, "rows": idx.numel(), "cols": 1, "axis": 0, "mask": table.numel() - 1}
