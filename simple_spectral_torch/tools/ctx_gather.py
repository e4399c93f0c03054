"""The f32[T, 3] row gather in its render context: a fresh index array
against the 9 bounces' rows of one [9, N] stack, one merged gather, three
1-D takes per row, mostly-zero indices, and rows feeding arithmetic
(PyTorch port of ``tools/bench_ctx_gather.py``).

    python -m simple_spectral_torch.tools.ctx_gather [out.json] [--n 262144] [--calls 16] [--device cpu]

The JAX tool's data (``tools/bench_ctx_gather.py:50-52``, ``:102``), drawn
by numpy's ``default_rng(0)`` in its order: ``table = normal(size=(T, 3))``
as f32, ``stack = integers(0, T, (9, N))``, ``idx1 = integers(0, T, N)``,
then ``mask = random(N) < 0.1``.  Its rows, with its labels and index
counts (``n_idx``), K = 16:

* "A row-gather, fresh [N] idx" (N);
* "B 9x row-gather, idx = stack[k]" (9N);
* "D merged [9N] row-gather" (9N);
* "E 9x 3-component 1-D takes" from the flattened table (27N);
* "F 9x row-gather, 90% zeroed idx": ``where(mask, stack[k], 0)`` (9N);
* "G 9x row-gather + row arithmetic": indices ``clip(stack[k], 0, T - 1)``,
  ``0.5 r0 + r1 + r2`` (9N).

Row C ("9x row-gather, barrier-laundered idx") passes each index row
through ``reshape`` and an ``optimization_barrier`` to change the layout
XLA gives it; eager torch has neither the layout choice nor the barrier,
so C would be row B again, and is left out.  The JAX rows xor the chain
token (0 for a finite output) into the indices; the port leaves it out.

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 16
between two synchronizes, host clock).  The file holds the JAX tool's
``{"device", "results"}`` (no ``rtt_ms``: no round trip is subtracted),
each row ``label``, ``ms`` and ``ns_per_index`` (over its ``n_idx``) with
K1's and K2's launches per call (0) and the peak device memory, unrounded.
A row that raises leaves ``error``, and the tool exits 1.  It runs on the
card unless ``--device cpu`` is given, and exits 1 without one; ``--n``
cuts the indices per bounce (not the table) for the CPU check.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from simple_spectral_torch.tools.gather_rows import D, bounce_sum, main_for, take

N = 262144
T = 262144
K_CALLS = 16
LEFT_OUT = ("C 9x row-gather, barrier-laundered idx",)


def draws(n: int, t: int = T):
    """The JAX tool's numpy draws, in its order: (table f32[t, 3], stack
    i32[9, n], idx1 i32[n], mask bool[n])."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(t, 3)).astype(np.float32)
    stack = rng.integers(0, t, (D, n)).astype(np.int32)
    idx1 = rng.integers(0, t, n).astype(np.int32)
    mask = rng.random(n) < 0.1
    return table, stack, idx1, mask


def rows(table: torch.Tensor, stack: torch.Tensor, idx1: torch.Tensor, mask: torch.Tensor) -> list:
    """The rows in order: (label, call of no arguments returning a scalar,
    n_idx)."""
    t, n = table.shape[0], idx1.shape[0]
    flat = table.reshape(-1)

    def three_takes(ti):
        base = ti.to(torch.int64) * 3
        return (flat[base] + flat[base + 1] + flat[base + 2]).sum()

    def arithmetic(ti):
        r = take(table, torch.clamp(ti, 0, t - 1))
        return (r[:, 0] * 0.5 + r[:, 1] + r[:, 2]).sum()

    return [
        ("A row-gather, fresh [N] idx", lambda: take(table, idx1).sum(), n),
        ("B 9x row-gather, idx = stack[k]", lambda: bounce_sum(lambda ti: take(table, ti).sum(), stack), D * n),
        ("D merged [9N] row-gather", lambda: take(table, stack.reshape(-1)).sum(), D * n),
        ("E 9x 3-component 1-D takes", lambda: bounce_sum(three_takes, stack), 3 * D * n),
        ("F 9x row-gather, 90% zeroed idx",
         lambda: bounce_sum(lambda ti: take(table, torch.where(mask, ti, 0)).sum(), stack), D * n),
        ("G 9x row-gather + row arithmetic", lambda: bounce_sum(arithmetic, stack), D * n),
    ]


def make_rows(n: int, dev) -> list:
    return rows(*(torch.from_numpy(a).to(dev) for a in draws(n)))


def main(argv=None) -> int:
    return main_for("ctx_gather", __doc__, N, K_CALLS, make_rows, lambda args: {}, argv)


if __name__ == "__main__":
    sys.exit(main())
