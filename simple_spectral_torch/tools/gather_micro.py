"""Texel gather formulations at the render's scale, 9 bounces x 262144
indices into a 262144-entry table: u32 words, f32[T, 3] rows, three planar
tables, one gather of all bounces, and the rows feeding the hero-wavelength
FMAs (PyTorch port of ``tools/bench_gather_micro.py``).

    python -m simple_spectral_torch.tools.gather_micro [out.json] [--n 262144] [--calls 12] [--device cpu]

The JAX tool's draws (``tools/bench_gather_micro.py:29-33``, ``:70``), all
from ``PRNGKey(0)`` through ``simple_spectral_torch.random``, bit-equal to
``jax.random``: ``tex_u32 = randint(key, (T,), 0, 2^24, uint32)`` (held as
int32: every value is below 2^24), ``tex_rows = uniform(key, (T, 3))``,
``tex_planar = uniform(key, (3, T))``, ``idx = randint(key, (9, N), 0, T)``
and ``bh = uniform(key, (3, 4, N))``.  Its rows, labels unchanged, K = 12:

* "u32 gather, fused sum       (9x)";
* "rows [T,3] gather, fused    (9x)";
* "planar 3x[T] gather, BARRIER(9x)": the three planes gathered apart;
* "rows [T,3] ONE [9N] gather, BARRIER ": one gather of all 9N indices;
* "rows gather BARRIER + hero FMA (9x)": ``bh[0] r0 + bh[1] r1 + bh[2] r2``
  over [4, N], summed.

The JAX tool's "u32 gather, BARRIER, sum" and "rows [T,3] gather, BARRIER"
rows put an ``optimization_barrier`` between the gather and its sum, to
keep XLA from fusing them.  Eager torch fuses nothing and has no barrier,
so those rows would time the same program as the first two; they are left
out.  Each call is one row's body: the "(9x)" rows sum their function over
the 9 bounces' index rows.

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 12
between two synchronizes, host clock).  The JAX tool only prints; with a
path this writes ``{"device", "results"}``, each row ``label``, ``ms``,
K1's and K2's launches per call (0) and the peak device memory, unrounded.
A row that raises leaves ``error``, and the tool exits 1.  It runs on the
card unless ``--device cpu`` is given, and exits 1 without one; ``--n``
cuts the indices per bounce (not the tables) for the CPU check.
"""

from __future__ import annotations

import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.tools.gather_rows import D, bounce_sum, main_for, take

N = 262144
T = 262144
K_CALLS = 12
# the JAX tool's rows that eager torch cannot tell from the rows before them
LEFT_OUT = ("u32 gather, BARRIER, sum    (9x)", "rows [T,3] gather, BARRIER  (9x)")
ONE_GATHER = "rows [T,3] ONE [9N] gather, BARRIER "


def draws(n: int, dev, t: int = T) -> dict:
    """The JAX tool's draws, all from ``PRNGKey(0)``, by name."""
    key = rnd.PRNGKey(0)
    return {
        "tex_u32": rnd.randint(key, (t,), 0, 1 << 24, device=dev),
        "tex_rows": rnd.uniform(key, (t, 3), dev),
        "tex_planar": rnd.uniform(key, (3, t), dev),
        "idx": rnd.randint(key, (D, n), 0, t, device=dev),
        "bh": rnd.uniform(key, (3, 4, n), dev),
    }


def row_calls(d: dict) -> dict:
    """The rows by label: each a call of no arguments returning a scalar."""
    tex_u32, tex_rows, tex_planar, idx, bh = (d[k] for k in ("tex_u32", "tex_rows", "tex_planar", "idx", "bh"))

    def fma(ti):
        rows = take(tex_rows, ti)
        v = bh[0] * rows[:, 0][None, :] + bh[1] * rows[:, 1][None, :] + bh[2] * rows[:, 2][None, :]
        return v.sum()

    def per_bounce(fn):
        return lambda: bounce_sum(fn, idx)

    return {
        "u32 gather, fused sum       (9x)": per_bounce(lambda ti: take(tex_u32, ti).to(torch.float32).sum()),
        "rows [T,3] gather, fused    (9x)": per_bounce(lambda ti: take(tex_rows, ti).sum()),
        "planar 3x[T] gather, BARRIER(9x)": per_bounce(
            lambda ti: sum(take(tex_planar[c], ti).sum() for c in range(3))),
        ONE_GATHER: lambda: take(tex_rows, idx.reshape(-1)).sum(),
        "rows gather BARRIER + hero FMA (9x)": per_bounce(fma),
    }


def make_rows(n: int, dev) -> list:
    return [(label, call, None) for label, call in row_calls(draws(n, dev)).items()]


def main(argv=None) -> int:
    return main_for("gather_micro", __doc__, N, K_CALLS, make_rows, lambda args: {}, argv)


if __name__ == "__main__":
    sys.exit(main())
