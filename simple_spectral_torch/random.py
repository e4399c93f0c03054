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

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  Keys are
small and stay on the host: ``split`` and ``fold_in`` hash them on Python
integers.  ``random_bits``, ``uniform`` and ``randint`` make their draws on
the device they are given.  On a CUDA device each draw is one launch of
kernel T1 (``csrc/threefry.cu``: the 20 rounds in uint32 and the draw's
epilogue, built and loaded like K1); on the CPU it runs the plain twins
(``random_bits_plain``, ``uniform_plain``, ``randint_plain``), whose
arithmetic runs in int64 with every result masked to 32 bits, since torch's
uint32 support is thin.  The card tests hold the kernel against the twins
bit for bit.  Every public draw and key hash runs in an ``ss.rng`` span
(``utils.profiling.span``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Union

import torch

from simple_spectral_torch import kernels
from simple_spectral_torch.utils.profiling import span

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]

# Launches of kernel T1, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("threefry.cu")
# threefry_launch(kind, ka0, ka1, kb0, kb1, n, width, mult, minval, out, stream)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_uint] * 8 + [ctypes.c_void_p] * 2
# the kernel's epilogues, and the dtype each stores
BITS, UNIFORM, RANDINT = 0, 1, 2
_DTYPES = {BITS: torch.int64, UNIFORM: torch.float32, RANDINT: torch.int32}


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


def _split_words(k1: int, k2: int, num: int) -> list:
    """The ``num`` keys of ``split`` as pairs of Python ints."""
    return [threefry2x32(k1, k2, 0, i) for i in range(num)]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, int64 ``[num, 2]``."""
    with span("ss.rng"):
        return torch.tensor(_split_words(*_words(key), num), dtype=torch.int64).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit integer."""
    with span("ss.rng"):
        k1, k2 = _words(key)
        b1, b2 = threefry2x32(k1, k2, 0, int(data) & MASK32)
        return torch.tensor([b1, b2], dtype=torch.int64)


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _on_cpu(device) -> bool:
    """Whether a draw on ``device`` (None: torch's default) takes the twin."""
    return (torch.get_default_device() if device is None else torch.device(device)).type == "cpu"


def draw_cuda(kind: int, keys: Sequence[int], shape: Shape, device, width: int = 1, mult: int = 0,
              minval: int = 0) -> torch.Tensor:
    """Launch T1 once: threefry2x32 of the counters ``(0, i)`` of a ``shape``
    draw under the key words ``keys`` (two; four for ``RANDINT``: its
    ``split`` keys), ending in the epilogue ``kind`` -> int64 bits, float32
    uniforms, or int32 ``minval + off`` with ``randint``'s ``width`` and
    ``mult``.  Raises on a device that is not CUDA and on 2^32 elements or
    more, before allocating."""
    global LAUNCHES
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"draw_cuda needs a CUDA device, got {dev}")
    shape = _shape(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} elements: the counter (0, i) holds fewer than 2^32")
    words = [int(k) & MASK32 for k in keys] + [0] * (4 - len(keys))
    out = torch.empty(shape, dtype=_DTYPES[kind], device=dev)
    if n == 0:
        return out
    launch = kernels.load(SOURCE, "threefry_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(kind, *words, n, width, mult, minval & MASK32, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def random_bits_plain(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """Plain int64 twin of T1's bits epilogue, on any device."""
    k1, k2 = _words(key)
    shape = _shape(shape)
    lo = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(shape)


def uniform_plain(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """Plain twin of T1's uniform epilogue, on any device."""
    bits = random_bits_plain(key, shape, device)
    fbits = (bits >> 9) | 0x3F800000  # < 2^31: exact in int32
    return torch.clamp_min(fbits.to(torch.int32).view(torch.float32) - 1.0, 0.0)


def _modulus(minval: int, maxval: int):
    """``randint``'s modulus, the width of [minval, maxval) (1 if empty), and
    its multiplier, (2^16 mod width) squared, as in JAX."""
    width = (maxval - minval) & MASK32 if maxval > minval else 1
    mult = (1 << 16) % width
    return width, ((mult * mult) & MASK32) % width  # the square wraps in uint32, as in JAX


def randint_plain(key: torch.Tensor, shape: Shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """Plain twin of T1's randint epilogue, on any device."""
    width, mult = _modulus(minval, maxval)
    ka, kb = split(key)
    higher = random_bits_plain(ka, shape, device)
    lower = random_bits_plain(kb, shape, device)
    off = (((higher % width) * mult) & MASK32) + (lower % width)
    off = (off & MASK32) % width
    return (minval + off).to(torch.int32)


def random_bits(key: torch.Tensor, shape: Shape, device=None) -> torch.Tensor:
    """32 random bits per element, int64 in [0, 2^32)."""
    with span("ss.rng"):
        if _on_cpu(device):
            return random_bits_plain(key, shape, device)
        return draw_cuda(BITS, _words(key), shape, device)


def uniform(key: torch.Tensor, shape: Shape = (), device=None) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over [0, 1)."""
    with span("ss.rng"):
        if _on_cpu(device):
            return uniform_plain(key, shape, device)
        return draw_cuda(UNIFORM, _words(key), shape, device)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` into int32, for int bounds in int32 range."""
    with span("ss.rng"):
        if _on_cpu(device):
            return randint_plain(key, shape, minval, maxval, device)
        width, mult = _modulus(minval, maxval)
        (a1, a2), (b1, b2) = _split_words(*_words(key), 2)
        return draw_cuda(RANDINT, (a1, a2, b1, b2), shape, device, width, mult, minval)
