"""Texel row layouts, gathered and unpacked to the same f32 values: jakob's
three coefficients and meng's six (point id, weight) pairs, as f32 rows or
packed u32 words, and the row width alone (PyTorch port of
``tools/bench_pack_micro.py``).

    python -m simple_spectral_torch.tools.pack_micro [out.json] [--n 262144] [--calls 16] [--device cpu]

The JAX tool's data (``tools/bench_pack_micro.py:47-96``), drawn by numpy's
``default_rng(0)`` in its order: ``idx = integers(0, T, N)`` (N = 262144
indices into T = 262144 rows), ``rows3 = normal(size=(T, 3))`` as f32, and
``rows12`` = ``integers(0, 200, (T, 6))`` as f32 beside ``random((T, 6),
f32)``.  The packed tables are built from them as the JAX tool builds them:

* ``packed2`` u32[T, 2]: the f16 bits of c0 (high half) and c1 (low half),
  then those of c2;
* ``w0``, ``w1``: its two columns as separate 1-D tables;
* ``packed6`` u32[T, 6]: point id << 16 | the weight's f16 bits.

Its nine rows (``:51-128``), each one gather of the N indices and an unpack
to f32, summed: "jakob f32[T,3] rows (current)", "jakob u32[T,2] f16-packed
rows", "jakob 2x separate u32 takes", "meng f32[T,12] rows (current)",
"meng u32[T,6] (u16 id | f16 w) rows", and the width probes f32[T,6],
f32[T,2], f32[T,1] and u32[T] 1-D (mallett's baseline).  torch's uint16 and
uint32 lack most kernels, so u32 words are held as int32 bits, and the f16
halves go through int16 (:func:`f16_bits`, :func:`f16_from_bits`); the
values are exactly the JAX tool's.

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 16
between two synchronizes, host clock).  The file holds the JAX tool's
``{"device", "n_indices", "table_rows", "results"}`` (no ``rtt_ms``: no
round trip is subtracted), each row ``label``, ``ms`` and ``ns_per_index``
(over N) with K1's and K2's launches per call and the peak device memory,
unrounded.  A row that raises leaves ``error``, and the tool exits 1.  It
runs on the card unless ``--device cpu`` is given, and exits 1 without one;
``--n`` cuts the indices (not the table) for the CPU check.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from simple_spectral_torch.tools.gather_rows import main_for, take

N = 262144
T = 262144  # 512^2 texels
K_CALLS = 16


def u32_float(words: torch.Tensor) -> torch.Tensor:
    """u32 words held as int32 bits -> their unsigned values in f32
    (``astype(jnp.float32)`` of a uint32 array)."""
    return (words.to(torch.int64) & 0xFFFFFFFF).to(torch.float32)


def f16_bits(x: torch.Tensor) -> torch.Tensor:
    """The f16 rounding of ``x`` as its 16 bits, an int32 in [0, 65536)
    (``bitcast_convert_type(x.astype(f16), uint16)``)."""
    return x.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF


def f16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bits in [0, 65536) (int32) -> the f16 they encode, widened to f32.
    torch's uint16 has no kernels for this, so the bits go through int16:
    the values 2^15 and above are moved to their negative twins first."""
    signed = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def draws(n: int, t: int = T):
    """The JAX tool's numpy draws, in its order: (idx i32[n], rows3
    f32[t, 3], rows12 f32[t, 12])."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, t, n).astype(np.int32)
    rows3 = rng.normal(size=(t, 3)).astype(np.float32)
    rows12 = np.concatenate([rng.integers(0, 200, (t, 6)).astype(np.float32),
                             rng.random((t, 6), dtype=np.float32)], axis=1)
    return idx, rows3, rows12


def pack2(rows3: torch.Tensor):
    """(w0, w1) int32[T]: the f16 bits of c0 << 16 | those of c1, and those
    of c2."""
    b = f16_bits(rows3)
    w0 = (b[:, 0].to(torch.int64) << 16) | b[:, 1]
    return torch.where(w0 >= 1 << 31, w0 - (1 << 32), w0).to(torch.int32), b[:, 2]


def pack6(rows12: torch.Tensor) -> torch.Tensor:
    """int32[T, 6]: each point id << 16 | its weight's f16 bits (ids < 200,
    so the words stay below 2^31)."""
    return (rows12[:, :6].to(torch.int32) << 16) | f16_bits(rows12[:, 6:])


def unpack2(a: torch.Tensor, b: torch.Tensor):
    """The three coefficients from the two words, f32."""
    return f16_from_bits((a >> 16) & 0xFFFF), f16_from_bits(a & 0xFFFF), f16_from_bits(b & 0xFFFF)


def row_fns(rows3: torch.Tensor, rows12: torch.Tensor) -> dict:
    """The nine rows by label: each maps the indices i32[n] to a scalar."""
    w0, w1 = pack2(rows3)
    packed2 = torch.stack([w0, w1], dim=1)
    packed6 = pack6(rows12)
    rows6, rows2, rows1 = rows12[:, :6].contiguous(), rows12[:, :2].contiguous(), rows12[:, :1].contiguous()

    def fetch_packed2(ti):
        r = take(packed2, ti)
        c0, c1, c2 = unpack2(r[:, 0], r[:, 1])
        return (c0 + c1 + c2).sum()

    def fetch_two(ti):
        c0, c1, c2 = unpack2(take(w0, ti), take(w1, ti))
        return (c0 + c1 + c2).sum()

    def fetch_packed6(ti):
        r = take(packed6, ti)
        pid = r >> 16
        return (pid.to(torch.float32) + f16_from_bits(r & 0xFFFF)).sum()

    return {
        "jakob f32[T,3] rows (current)": lambda ti: take(rows3, ti).sum(),
        "jakob u32[T,2] f16-packed rows": fetch_packed2,
        "jakob 2x separate u32 takes": fetch_two,
        "meng f32[T,12] rows (current)": lambda ti: take(rows12, ti).sum(),
        "meng u32[T,6] (u16 id | f16 w) rows": fetch_packed6,
        "width probe f32[T,6] rows": lambda ti: take(rows6, ti).sum(),
        "width probe f32[T,2] rows": lambda ti: take(rows2, ti).sum(),
        "width probe f32[T,1] rows": lambda ti: take(rows1, ti).sum(),
        "width probe u32[T] 1-D (mallett baseline)": lambda ti: u32_float(take(w0, ti)).sum(),
    }


def make_rows(n: int, dev) -> list:
    idx, rows3, rows12 = (torch.from_numpy(a).to(dev) for a in draws(n))
    return [(label, lambda fn=fn: fn(idx), n) for label, fn in row_fns(rows3, rows12).items()]


def main(argv=None) -> int:
    return main_for("pack_micro", __doc__, N, K_CALLS, make_rows,
                    lambda args: {"n_indices": args.n, "table_rows": T}, argv)


if __name__ == "__main__":
    sys.exit(main())
