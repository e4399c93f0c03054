"""Counter-based threefry2x32 random numbers, bit-exact with ``jax.random``.

Why not ``torch.Generator``: with the exact JAX streams, the port's
``trace_lanes`` can be held against the JAX integrator lane by lane instead
of only statistically.  The streams follow JAX's defaults (``threefry2x32``
with ``jax_threefry_partitionable=True``):

- ``split(key, n)``: the hash of the counter pairs ``(0, i)``, i < n;
- ``fold_in(key, x)``: the hash of the single pair ``(0, x)``;
- 32 random bits at flat index i: ``hi ^ lo`` of the hash of ``(0, i)``;
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus 1;
- ``randint``: two independent 32-bit draws combined modulo the span.

Torch's uint32 support is thin, so the arithmetic runs in int64 with every
result masked to 32 bits.  A key is an int64 tensor ``[..., 2]`` holding two
uint32 words.  Keys are small and stay on the host; ``uniform`` and
``randint`` make their draws on the device they are given.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block function (20 rounds) on 32-bit words held in
    int64 tensors or Python ints; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey`` with 32-bit integers: the seed keeps its low 32
    bits and the high word is 0."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _words(key: torch.Tensor):
    if key.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {tuple(key.shape)}")
    k = key.tolist()
    return int(k[0]), int(k[1])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, int64 ``[num, 2]``."""
    k1, k2 = _words(key)
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit integer."""
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, 0, int(data) & MASK32)
    return torch.tensor([b1, b2], dtype=torch.int64)


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def random_bits(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """32 random bits per element, int64 in [0, 2^32)."""
    k1, k2 = _words(key)
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over [0, 1)."""
    bits = random_bits(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000  # < 2^31: exact in int32
    return torch.clamp_min(fbits.to(torch.int32).view(torch.float32) - 1.0, 0.0)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` into int32, for int bounds in int32 range."""
    ka, kb = split(key)
    higher = random_bits(ka, shape, device)
    lower = random_bits(kb, shape, device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span  # the square wraps in uint32, as in JAX
    off = (((higher % span) * mult) & MASK32) + (lower % span)
    off = (off & MASK32) % span
    return (minval + off).to(torch.int32)
