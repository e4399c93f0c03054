"""Faults planted under a cell's timed path, for the tests that see
``correct`` come out false.  Each breaks the program where its output is
produced and leaves the harness and the reference alone.

- ``unchanged``: the step returns its state unchanged: a train step's
  gradients are zero, a pass adds nothing to the accumulator;
- ``half``: half of the batch left out: a train step's loss is the mean over
  the first half of its lanes, a pass renders only the first half of its
  pixels;
- ``altered``: one answer altered where it is produced: the largest entry of
  a train step's first gradient table, or the largest value of a pass's
  chunk, times 1.01;
- ``no_exchange``: the exchange between processes left out: every
  ``torch.distributed.all_reduce`` returns its input unchanged.

Where to plant them is data of the entries: each module of
``benchmark/entries/`` names in ``FAULT_HOOKS`` the program functions under
its timed path, as (module, function, kind of output, index of the lanes
among the positional arguments).  The kinds are ``train`` (returns the loss
and a dict of gradient tables; the targets follow the lanes) and ``render``
(returns the chunk's values and alphas, a row per lane).

``plant(name)`` patches the program's modules in this process; a launcher of
several processes plants it in each (``drive.py`` through
``BENCH_TEST_FAULT``).
"""

from __future__ import annotations

import importlib
import os
import pkgutil

import torch

FAULTS = ("unchanged", "half", "altered", "no_exchange")
ENTRIES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "entries")


def hooks() -> list:
    """Every entry's ``FAULT_HOOKS``."""
    out = []
    for m in pkgutil.iter_modules([ENTRIES]):
        out += getattr(importlib.import_module(f"benchmark.entries.{m.name}"), "FAULT_HOOKS", ())
    return out


def _scale_largest(x: torch.Tensor) -> torch.Tensor:
    flat = x.clone().reshape(-1)
    flat[torch.argmax(torch.abs(flat))] *= 1.01
    return flat.reshape(x.shape)


def _wrap(fault: str, kind: str, at: int, fn):
    if fault == "unchanged" and kind == "train":
        def wrapped(*a, **k):
            loss, grads = fn(*a, **k)
            return loss, {f: torch.zeros_like(g) for f, g in grads.items()}
    elif fault == "unchanged":
        def wrapped(*a, **k):
            v, al = fn(*a, **k)
            return torch.zeros_like(v), torch.zeros_like(al)
    elif fault == "half" and kind == "train":
        def wrapped(*a, **k):
            h = a[at].shape[0] // 2
            return fn(*a[:at], a[at][:h], a[at + 1][:h], *a[at + 2:], **k)
    elif fault == "half":
        def wrapped(*a, **k):
            v, al = fn(*a, **k)
            h = a[at].shape[0] // 2
            return torch.cat([v[:h], torch.zeros_like(v[h:])]), al
    elif kind == "train":  # altered
        def wrapped(*a, **k):
            loss, grads = fn(*a, **k)
            first = next(iter(grads))
            return loss, dict(grads, **{first: _scale_largest(grads[first])})
    else:
        def wrapped(*a, **k):
            v, al = fn(*a, **k)
            return _scale_largest(v), al
    return wrapped


def plant(name: str) -> None:
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; have {FAULTS}")
    if name == "no_exchange":
        import torch.distributed as dist

        dist.all_reduce = lambda tensor, *a, **k: None
        return
    for mod_name, attr, kind, at in hooks():
        mod = importlib.import_module(mod_name)
        setattr(mod, attr, _wrap(name, kind, at, getattr(mod, attr)))
