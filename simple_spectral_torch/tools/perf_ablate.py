"""Ablation timings of the render paths: what texture, next-event estimation,
spectra, depth, the backward, ``spp_chunk`` and ``remat`` each cost
(PyTorch port of ``tools/perf_ablate.py``).

    python -m simple_spectral_torch.tools.perf_ablate [out.json] [group ...] [--calls K] [--lanes N]
        [--size S] [--max-depth D] [--device cpu]

Groups: fwd, split, bwd, chunk, remat (default: all), with the JAX tool's
rows, labels and configurations (``tools/perf_ablate.py:121-173``):

* a ``render`` row times ``_render_chunk`` of N = 262144 lanes (pixels
  ``arange(N)``) at 1 spp; call i folds i into the previous call's key
  (the JAX chain token, 0 for a finite output, folded in as 0).  It counts
  ``N * (2 * max_depth - 1)`` rays with explicit light sampling and ``N *
  max_depth`` without;
* a ``fwd`` or ``fwd+bwd`` row times ``forward_only_step`` or
  ``forward_backward_step`` at ``spp_chunk`` samples (4 unless the row says
  otherwise) on ``lanes = min(w * h, max_lanes // spp_chunk, N)`` lanes, a
  zero target and ``remat``, with the key ``fold_in(fold_in(PRNGKey(0), i),
  0)``; rays count the forward's, ``lanes * spp_chunk`` samples;
* "TEXTURE STRIPPED" rows drop the scene's texture (``texture=None``) and
  leave the materials' albedo kinds as they are.

Every row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 12
render or 10 step calls between two synchronizes, host clock).  A row that
raises is written as ``{"label", "error"}`` and the run goes on; the tool
then exits 1.  The JSON file has the JAX tool's ``device`` (here the card's
name and power limit), ``lanes`` and ``results`` (``label``,
``ms_per_call``, ``mrays_per_s``); each row adds the launches of K1 and K2
per call and the peak device memory.  Numbers are unrounded.  It runs on
the card unless ``--device cpu`` is given, and exits 1 without one; the
cuts check the program at a small size.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

N = 262144
GROUPS = ("fwd", "split", "bwd", "chunk", "remat")
K_RENDER, K_STEP = 12, 10


@dataclasses.dataclass(frozen=True)
class Row:
    """One row of the table: ``step`` is "render" (``_render_chunk`` at 1
    spp), "fwd" (``forward_only_step``) or "fwd+bwd"
    (``forward_backward_step``); ``spp_chunk`` and ``remat`` are the steps'."""

    label: str
    cfg: RenderConfig
    step: str = "render"
    strip_texture: bool = False
    spp_chunk: int = 4
    remat: str = "none"


def rows(groups) -> list:
    """The rows of ``groups``, in the JAX tool's order."""
    base = dict(width=512, height=512, spp=64)
    canon = RenderConfig(scene="cornell-srgb", mode="mallett", **base)

    def cfg(scene, mode, **kw):
        return RenderConfig(scene=scene, mode=mode, **base, **kw)

    out = []
    if "fwd" in groups:
        out += [
            Row("fwd cornell-srgb mallett ELS (canonical)", canon),
            Row("fwd cornell-srgb mallett TEXTURE STRIPPED", canon, strip_texture=True),
            Row("fwd cornell      mallett ELS (no texture)", cfg("cornell", "mallett")),
            Row("fwd cornell-srgb mallett noELS (no NEE)", cfg("cornell-srgb", "mallett", els=False)),
            Row("fwd cornell-srgb rgb     ELS (no spectra)", cfg("cornell-srgb", "rgb")),
            Row("fwd cornell      rgb     noELS (minimal)", cfg("cornell", "rgb", els=False)),
            Row("fwd cornell-srgb mallett ELS depth=2", cfg("cornell-srgb", "mallett", max_depth=2)),
            Row("fwd cornell-srgb meng    ELS", cfg("cornell-srgb", "meng")),
            Row("fwd cornell-srgb jakob   ELS", cfg("cornell-srgb", "jakob")),
        ]
    if "split" in groups:
        out += [
            Row("FWD-only loss canonical", canon, "fwd"),
            Row("FWD+BWD canonical", canon, "fwd+bwd"),
            Row("FWD-only loss TEXTURE STRIPPED", canon, "fwd", strip_texture=True),
            Row("FWD+BWD TEXTURE STRIPPED", canon, "fwd+bwd", strip_texture=True),
            Row("FWD+BWD cornell mallett (no texture)", cfg("cornell", "mallett"), "fwd+bwd"),
            Row("FWD+BWD cornell-srgb rgb", cfg("cornell-srgb", "rgb"), "fwd+bwd"),
            Row("FWD+BWD canonical no remat_cache", canon.replace(remat_cache=False), "fwd+bwd"),
            Row("FWD-only canonical intersect=xla2", canon.replace(intersect_impl="xla2"), "fwd"),
            Row("FWD+BWD canonical intersect=xla2", canon.replace(intersect_impl="xla2"), "fwd+bwd"),
        ]
    if "bwd" in groups:
        # where the backward goes: spectra, the per-bounce shading, or fixed cost
        for what, c in (("rgb", cfg("cornell", "rgb")),
                        ("mallett S=1", cfg("cornell", "mallett", n_wavelengths=1)),
                        ("mallett depth=2", cfg("cornell", "mallett", max_depth=2))):
            out += [Row(f"BWD-iso {what} stripped FWD-only", c, "fwd"),
                    Row(f"BWD-iso {what} stripped FWD+BWD", c, "fwd+bwd")]
        out += [Row("BWD-iso canonical spp_chunk=1 FWD-only", canon, "fwd", spp_chunk=1),
                Row("BWD-iso canonical spp_chunk=1 FWD+BWD", canon, "fwd+bwd", spp_chunk=1)]
    if "chunk" in groups:
        out += [Row(f"FWD+BWD canonical spp_chunk={c}", canon, "fwd+bwd", spp_chunk=c) for c in (2, 8, 16)]
    if "remat" in groups:
        out += [Row("FWD+BWD canonical remat=trace", canon, "fwd+bwd", remat="trace"),
                Row("FWD+BWD remat=trace spp_chunk=16", canon, "fwd+bwd", spp_chunk=16, remat="trace")]
    return out


def lanes_of(row: Row, n: int = N) -> int:
    """Lanes of one call: ``n`` for a render row; the step's lane count,
    ``min(w * h, max_lanes // spp_chunk, n)``, for the others."""
    if row.step == "render":
        return n
    return min(row.cfg.width * row.cfg.height, row.cfg.max_lanes // max(row.spp_chunk, 1), n)


def rays_of(row: Row, n: int = N) -> float:
    """Rays of one call, as the JAX tool counts them (the forward's)."""
    per_sample = 2 * row.cfg.max_depth - 1 if row.cfg.els else row.cfg.max_depth
    if row.step == "render":
        return n * per_sample
    return float(lanes_of(row, n)) * row.spp_chunk * per_sample


def strip_texture(scene):
    """The scene without its texture; the albedo kinds stay as they are."""
    return dataclasses.replace(scene, texture=None)


def measure(row: Row, n: int, k_calls: int, dev) -> dict:
    """Time one row on ``dev``: {"label", "ms_per_call", "mrays_per_s",
    "k1_launches_per_call", "k2_launches_per_call", "peak_bytes"}."""
    from simple_spectral_torch.render.renderer import _render_chunk
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = row.cfg
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    if row.strip_texture:
        scene = strip_texture(scene)
    lanes = lanes_of(row, n)
    px = torch.arange(lanes, dtype=torch.int32, device=dev)
    if row.step == "render":
        chain = [rnd.PRNGKey(0)]

        def step(i):
            chain[0] = rnd.fold_in(chain[0], i)
            return _render_chunk(scene, tables, cfg, chain[0], px, 1)
    else:
        fn = forward_only_step if row.step == "fwd" else forward_backward_step
        target = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)
        key = rnd.PRNGKey(0)

        def step(i):
            return fn(scene, tables, cfg, rnd.fold_in(rnd.fold_in(key, i), 0), px, target, row.spp_chunk, row.remat)

    res = time_calls(step, k_calls, [dev])
    dt = res.pop("seconds_per_call")
    return {"label": row.label, "ms_per_call": dt * 1e3, "mrays_per_s": rays_of(row, n) / dt / 1e6, **res}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("args", nargs="*", metavar="[out.json] [group ...]")
    add_tool_args(p, lanes=N, calls=True)
    args = p.parse_args(argv)
    out = args.args[0] if args.args and args.args[0].endswith(".json") else None
    groups = set(args.args[1:] if out else args.args) or set(GROUPS)
    if groups - set(GROUPS):
        p.error(f"unknown groups {sorted(groups - set(GROUPS))}; groups are {', '.join(GROUPS)}")
    dev = tool_device(args.device, "perf_ablate")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "lanes": args.lanes, "results": []}
    for row in rows(groups):
        row = dataclasses.replace(row, cfg=cut(row.cfg, args))
        k_calls = args.calls or (K_RENDER if row.step == "render" else K_STEP)
        res, err = guarded(row.label, measure, row, args.lanes, k_calls, dev)
        data["results"].append(res or {"label": row.label, "error": err})
        if res:
            print(f"{row.label:52s} {res['ms_per_call']:9.2f} ms/call  {res['mrays_per_s']:8.2f} Mrays/s  "
                  f"K1 {res['k1_launches_per_call']} K2 {res['k2_launches_per_call']} per call", flush=True)
        write_json(out, data)
    if out:
        print(f"wrote {out}", flush=True)
    return 1 if any("error" in r for r in data["results"]) else 0


if __name__ == "__main__":
    sys.exit(main())
