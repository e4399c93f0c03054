"""Where the fixed cost of a call lives: the train step, the forward alone
and the render alone against the lane count, for cfg1's rgb cornell and for
mallett on cornell-srgb, and the cost of one eager key fold (PyTorch port
of ``tools/diag_cfg1.py``).

    python -m simple_spectral_torch.tools.diag_cfg1 [out.json] [--lanes N ...] [--calls 8]
        [--size S] [--max-depth D] [--device cpu]

Rows, with the JAX tool's labels (``tools/diag_cfg1.py:49-104``):

* "eager fold_in per op": 64 chained ``fold_in(k, i)`` from ``PRNGKey(0)``,
  then a synchronize of the device, over 64.  The port's keys are two
  32-bit words that ``simple_spectral_torch.random`` hashes on the host in
  Python (``bench.py`` builds its keys so, two folds a call), so this is
  the host's time;
* for each configuration, "rgb cornell (cfg1 scene)" (cornell, rgb, 128^2)
  and "mallett cornell-srgb" (cornell-srgb, mallett, 128^2), and each lane
  count in 16384, 65536 and 262144 (``--lanes`` replaces them), three rows
  on pixels ``arange(lanes) % (w h)`` at 1 spp: "{config} fwd+bwd
  lanes={lanes}" (``forward_backward_step``, zero target), "... fwd-only"
  (``forward_only_step``) and "... render-only" (``_render_chunk``).  Call
  i takes the key ``fold_in(fold_in(PRNGKey(0), i), 0)``, the JAX chain's
  with its token of 0.  Rays count ``lanes * (2 max_depth - 1)``.

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 8
between two synchronizes, host clock) and holds ``label``, ``ms``,
``mrays_s``, K1's and K2's launches per call and the peak device memory,
unrounded.  The file holds ``{"device", "results", "fixed_ms"}``:
``fixed_ms`` maps each "{config} {step}" to the least-squares intercept of
``ms`` against ``lanes`` over its rows, which this tool fits: the call's
cost at zero lanes, the fixed cost a call pays on this device (None with
fewer than two lane counts).  No ``rtt_ms``: no round trip is subtracted.
A row that raises leaves ``error``, and the tool exits 1.  It runs on the
card unless ``--device cpu`` is given, and exits 1 without one; ``--size``,
``--max-depth`` and ``--lanes`` cut it for the CPU check.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import cut, guarded, time_calls, tool_device, write_json

LANES = (16384, 65536, 262144)
K_CALLS = 8
FOLDS = 64
STEPS = ("fwd+bwd", "fwd-only", "render-only")
FOLD_LABEL = "eager fold_in per op"


def configs() -> dict:
    """The JAX tool's two configurations (``tools/diag_cfg1.py:59-64``)."""
    return {
        "rgb cornell (cfg1 scene)": RenderConfig(scene="cornell", mode="rgb", width=128, height=128, spp=8),
        "mallett cornell-srgb": RenderConfig(scene="cornell-srgb", mode="mallett", width=128, height=128, spp=8),
    }


def table(lanes=LANES) -> list:
    """The timed rows in the JAX tool's order: (label, configuration name,
    step, lanes)."""
    return [(f"{cname} {step} lanes={n}", cname, step, n) for cname in configs() for n in lanes for step in STEPS]


def rays_of(cfg: RenderConfig, lanes: int) -> int:
    return lanes * (2 * cfg.max_depth - 1)


def pixels(cfg: RenderConfig, lanes: int, dev) -> torch.Tensor:
    return torch.arange(lanes, dtype=torch.int32, device=dev) % (cfg.width * cfg.height)


def call_key(i: int) -> torch.Tensor:
    return rnd.fold_in(rnd.fold_in(rnd.PRNGKey(0), i), 0)


def fold_row(dev) -> dict:
    """The eager key fold's cost: 64 chained folds, then a synchronize."""
    t0 = time.perf_counter()
    k = rnd.PRNGKey(0)
    for i in range(FOLDS):
        k = rnd.fold_in(k, i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"label": FOLD_LABEL, "ms": (time.perf_counter() - t0) / FOLDS * 1e3}


def step_fn(step: str, scene, tables, cfg, px):
    """Call i of a row: the step on ``call_key(i)``."""
    from simple_spectral_torch.render.renderer import _render_chunk
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step

    if step == "render-only":
        return lambda i: _render_chunk(scene, tables, cfg, call_key(i), px, 1)
    fn = forward_backward_step if step == "fwd+bwd" else forward_only_step
    target = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    return lambda i: fn(scene, tables, cfg, call_key(i), px, target, 1)


def measure(label: str, step: str, scene, tables, cfg, lanes: int, k_calls: int, dev) -> dict:
    res = time_calls(step_fn(step, scene, tables, cfg, pixels(cfg, lanes, dev)), k_calls, [dev])
    dt = res.pop("seconds_per_call")
    return {"label": label, "ms": dt * 1e3, "mrays_s": rays_of(cfg, lanes) / dt / 1e6, **res}


def line_fit(points):
    """(intercept ms, ms per lane) of the least-squares line of ms against
    lanes over ``points``, [(lanes, ms)], at two lane counts or more; else
    None."""
    if len({x for x, _ in points}) < 2:
        return None
    x, y = np.array(points, dtype=np.float64).T
    slope, intercept = np.polyfit(x, y, 1)
    return float(intercept), float(slope)


def build(cfg: RenderConfig, dev):
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device=dev)
    return build_scene(cfg, tables, device=dev), tables


def main(argv=None) -> int:
    from simple_spectral_torch.bench import device_line

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--lanes", type=int, nargs="+", default=list(LANES), help="lane counts (default: 16384 65536 "
                   "262144)")
    p.add_argument("--calls", type=int, default=K_CALLS, help=f"timed calls per row (default {K_CALLS})")
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    p.add_argument("--size", type=int, default=None, help="image side of both configurations (default 128)")
    p.add_argument("--max-depth", type=int, default=None, help="cap on both configurations' depth")
    args = p.parse_args(argv)
    dev = tool_device(args.device, "diag_cfg1")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "results": [fold_row(dev)], "fixed_ms": {}}
    print(f"eager fold_in: {data['results'][0]['ms']} ms/op (host)", flush=True)
    cfgs = {cname: cut(cfg, args) for cname, cfg in configs().items()}
    built, points, fits = {}, {}, {}
    for label, cname, step, lanes in table(args.lanes):
        cfg = cfgs[cname]
        if cname not in built:
            built[cname] = guarded(cname, build, cfg, dev)
        scene_tables, build_err = built[cname]
        res, err = (guarded(label, measure, label, step, *scene_tables, cfg, lanes, args.calls, dev)
                    if scene_tables else (None, build_err))
        data["results"].append(res or {"label": label, "error": err})
        if res:
            points.setdefault(f"{cname} {step}", []).append((lanes, res["ms"]))
            print(f"{label:58s} {res['ms']:10.3f} ms  {res['mrays_s']:9.3f} Mrays/s  "
                  f"K1 {res['k1_launches_per_call']} K2 {res['k2_launches_per_call']} per call", flush=True)
        fits = {key: line_fit(pts) for key, pts in points.items()}
        data["fixed_ms"] = {key: f and f[0] for key, f in fits.items()}
        write_json(args.out, data)
    for key, f in fits.items():
        if f:
            print(f"fit, {key}: {f[0]} ms fixed + {f[1] * 65536} ms per 65536 lanes", flush=True)
    write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if any("error" in r for r in data["results"]) else 0


if __name__ == "__main__":
    sys.exit(main())
