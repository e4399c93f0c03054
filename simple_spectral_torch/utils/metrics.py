"""Render metrics (PyTorch port of ``simple_spectral_tpu.utils.metrics``).

The same accounting and the same JSON keys as the JAX package, so a
``--metrics-json`` line means the same in both: 1 camera ray + (MAX_DEPTH-1)
x (1 shadow + 1 BSDF) intersects per sample with ELS on, MAX_DEPTH with ELS
off (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List

from simple_spectral_torch.config import RenderConfig


def rays_per_sample(cfg: RenderConfig) -> int:
    return 2 * cfg.max_depth - 1 if cfg.els else cfg.max_depth


@dataclasses.dataclass
class RenderMetrics:
    cfg: RenderConfig
    spp_done: int = 0
    wall_s: float = 0.0
    pass_times: List[float] = dataclasses.field(default_factory=list)

    def record_pass(self, pass_spp: int, seconds: float) -> None:
        self.spp_done += pass_spp
        self.wall_s += seconds
        self.pass_times.append(seconds)

    @property
    def rays_traced(self) -> int:
        return self.cfg.width * self.cfg.height * self.spp_done * rays_per_sample(self.cfg)

    @property
    def mrays_per_s(self) -> float:
        return self.rays_traced / self.wall_s / 1e6 if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        c = self.cfg
        return {
            "scene": c.scene,
            "mode": c.mode,
            "observer": c.observer,
            "resolution": [c.width, c.height],
            "spp": self.spp_done,
            "max_depth": c.max_depth,
            "els": c.els,
            "rays_traced": self.rays_traced,
            "wall_s": round(self.wall_s, 4),
            "mrays_per_s": round(self.mrays_per_s, 3),
            "n_passes": len(self.pass_times),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def synchronize(result) -> None:
    """Wait for the CUDA device of every tensor in ``result`` (a tensor or
    a nest of tuples, lists and dicts), as ``jax.block_until_ready`` does."""
    import torch

    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            synchronize(v)


class Timer:
    """Wall-clock timer that waits for the device results it is given, so
    that it times the device's work and not the enqueue."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        return False

    def stop(self, result=None):
        if result is not None:
            synchronize(result)
        self.elapsed = time.time() - self.t0
        return self.elapsed
