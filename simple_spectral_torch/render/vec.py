"""Vector math over structure-of-arrays triples (PyTorch port of
``simple_spectral_tpu.render.vec``).

Hot math runs on ``V3 = (x, y, z)`` tuples of same-shaped ``[N]`` tensors,
the JAX package's lanes-last layout, so the two packages compare lane for
lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s):
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def v3_from_rows(a: torch.Tensor) -> V3:
    """f32[..., 3] -> V3 of f32[...]."""
    return V3(a[..., 0], a[..., 1], a[..., 2])


def splat(a: torch.Tensor, like: torch.Tensor) -> V3:
    """f32[3] constant -> V3 broadcast against ``like``."""
    return V3(a[0].expand(like.shape), a[1].expand(like.shape), a[2].expand(like.shape))


def dot(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x)


def normalize(a: V3) -> V3:
    r = torch.rsqrt(dot(a, a))
    return V3(a.x * r, a.y * r, a.z * r)


def where(c: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z))


def select3(k: torch.Tensor, a, b, c):
    """Per-element component select: k in {0,1,2} -> a/b/c."""
    return torch.where(k == 0, a, torch.where(k == 1, b, c))
