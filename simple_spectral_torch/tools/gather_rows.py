"""What the texel gather benches share (``texture_micro``, ``pack_micro``,
``gather_micro``, ``ctx_gather``): the per-call body that sums one function
over the D = 9 bounces' index rows, the row writer, and the tools' loop over
their rows.

Each JAX tool jits one body per row and chains call i + 1 to call i through
a token, ``int32(out * 1e-30)``, that it adds to or xors into the indices.
The token is 0 for any finite output, so the port leaves it out: a call is
the row's body on the same inputs, and ``tools.time_calls`` checks that
every timed call's output is finite.  Eager torch fuses nothing, so each
row's body runs as the torch ops it is written in, one launch each; that is
how the port's render fetches its texels (``render/shading.py``
``texel_fetch_lrgb`` and ``texture_albedo_deferred``).
"""

from __future__ import annotations

import argparse

import torch

from simple_spectral_torch.tools import guarded, time_calls, tool_device, write_json

D = 9  # bounces that fetch a texel per sample at depth 10


def bounce_sum(fn, idx: torch.Tensor):
    """``fn(idx[0]) + ... + fn(idx[D - 1])``: the JAX tools' per-call body,
    ``acc = 0; for k in range(D): acc = acc + fn(idx[k] + tok)``, with its
    token of 0 left out."""
    acc = 0.0
    for k in range(idx.shape[0]):
        acc = acc + fn(idx[k])
    return acc


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` for in-range indices."""
    return table[idx.to(torch.int64)]


def measure(label: str, call, k_calls: int, dev, n_idx: int = None) -> dict:
    """One row: ``call()`` timed by ``tools.time_calls`` -> {"label", "ms"
    [, "ns_per_index"], "k1_launches_per_call", "k2_launches_per_call",
    "peak_bytes"}; ``ns_per_index`` is the time over ``n_idx`` indices,
    where the JAX tool writes it."""
    res = time_calls(lambda i: call(), k_calls, [dev])
    dt = res.pop("seconds_per_call")
    row = {"label": label, "ms": dt * 1e3}
    if n_idx is not None:
        row["ns_per_index"] = dt / n_idx * 1e9
    return {**row, **res}


def run_rows(tool: str, rows, k_calls: int, dev, out, head: dict) -> int:
    """Time ``rows``, a list of (label, call, n_idx or None), in order;
    write ``{**head, "results": [...]}`` to ``out`` after every row.  A row
    that raises is written ``{"label", "error"}`` and the run goes on.
    Returns the exit code: 1 if a row failed, else 0."""
    data = {**head, "results": []}
    print(f"{tool}: {'label':44s} {'ms':>10s}  K1  K2  peak MB", flush=True)
    for label, call, n_idx in rows:
        res, err = guarded(label, measure, label, call, k_calls, dev, n_idx)
        data["results"].append(res or {"label": label, "error": err})
        if res:
            peak = "-" if res["peak_bytes"] is None else f"{res['peak_bytes'] / 1e6:.1f}"
            print(f"{tool}: {label:44s} {res['ms']:10.4f} {res['k1_launches_per_call']:3d} "
                  f"{res['k2_launches_per_call']:3d}  {peak}", flush=True)
        write_json(out, data)
    if out:
        print(f"wrote {out}", flush=True)
    return 1 if any("error" in r for r in data["results"]) else 0


def main_for(tool: str, doc: str, n: int, k_calls: int, make_rows, head, argv=None) -> int:
    """A gather bench's ``main``: parse the arguments, find the device (exit
    1 without a card), build the rows with ``make_rows(n, dev)`` and time
    them; ``head(args)`` gives the file's keys besides ``device`` and
    ``results``."""
    from simple_spectral_torch.bench import device_line

    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--n", type=int, default=n, help=f"indices per gather (default {n}; a cut for the CPU check)")
    p.add_argument("--calls", type=int, default=k_calls, help=f"timed calls per row (default {k_calls})")
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    args = p.parse_args(argv)
    dev = tool_device(args.device, tool)
    if dev is None:
        return 1
    with torch.no_grad():
        return run_rows(tool, make_rows(args.n, dev), args.calls, dev, args.out,
                        {"device": device_line(dev), **head(args)})

