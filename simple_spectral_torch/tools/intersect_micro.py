"""The closest-hit sweep's costs at T = 38, split: K1's key alone, the dense
route without and with the winner's attributes (PyTorch port of
``tools/bench_intersect_micro.py``).

    python -m simple_spectral_torch.tools.intersect_micro [out.json] [--rays 262144] [--calls 16] [--device cpu]

The JAX tool's inputs (``tools/bench_intersect_micro.py:28-33``): cornell
(``RenderConfig(scene="cornell", mode="rgb", width=8, height=8, spp=1)``, 38
triangles), 262144 rays from :func:`random_rays` at seed 3, the port's own
copy of ``tests/test_intersect_pallas.py`` ``_random_rays`` (origins
uniform inside the vertex bounds shrunk by 5% a side, normalized normal
directions, drawn in f64 and rounded to f32), no ignored primitive, eps
1e-3.  Its seven variants, by name, each timed by ``tools.time_calls`` (2
warm-up calls, then K = 16 between two synchronizes, host clock):

* ``xla attrs`` / ``xla noattrs``: the dense route on K1's exact 64-bit key
  (``intersect_rays_pallas(exact=True)``), with and without the recovery of
  the winner's attributes;
* ``xla2 attrs``, ``xla2 noattrs``, ``pallas noattrs``, ``pallas attrs``: the
  same on K1's quantized 32-bit key (``intersect_rays_pallas``);
* ``pallas key only``: ``intersect_best_key`` with the quantized key, K1
  alone.

In the JAX package ``xla2`` (``intersect_rays_soa2``) and ``pallas``
(the Pallas kernel) are two programs for one key; in the port both names
resolve to "pallas" (``render/intersect.py`` ``resolve_intersect_impl``)
and run the same code, so their rows time one program twice.  Each call
returns a finite reduction of its output (the sum of the finite distances,
or of the keys), as the JAX tool's chained step does.

Prints a table of ms and Mrays/s per variant with K1's and K2's launches per
call and the peak memory; with a path it writes ``{"device", "rays",
"results"}`` (the JAX tool writes no file), rows unrounded.  A variant that
raises leaves ``error``, and the tool exits 1.  It runs on the card unless
``--device cpu`` is given, and exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.intersect import intersect_rays_pallas
from simple_spectral_torch.render.intersect_pallas import intersect_best_key
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.tools import guarded, time_calls, tool_device, write_json
from simple_spectral_torch.tools.cull_micro import v3

N_RAYS = 262144
SEED = 3
K_CALLS = 16
EPS = 1e-3


def scene_config() -> RenderConfig:
    """``tests/test_intersect_pallas.py`` ``_scene("cornell")``."""
    return RenderConfig(scene="cornell", mode="rgb", width=8, height=8, spp=1)


def random_rays(scene, n: int, seed: int = 0):
    """Origins jittered inside the scene's vertex bounds, random sphere
    directions (``tests/test_intersect_pallas.py`` ``_random_rays``): (o V3,
    d V3) on the scene's device."""
    rng = np.random.default_rng(seed)
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return v3(o.astype(np.float32), scene.device), v3(d.astype(np.float32), scene.device)


def finite_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0).sum()


def variants(scene, d: V3, ign: torch.Tensor) -> dict:
    """The JAX tool's variants, by name: each maps origins to a finite
    scalar of the sweep's output."""
    def route(exact: bool, need_attrs: bool):
        return lambda o: finite_sum(intersect_rays_pallas(scene, o, d, ign, EPS, need_attrs, exact=exact).dist)

    return {
        "xla attrs": route(True, True),
        "xla noattrs": route(True, False),
        "xla2 attrs": route(False, True),
        "xla2 noattrs": route(False, False),
        "pallas key only": lambda o: intersect_best_key(scene.tri_verts, scene.tri_prim, o, d, ign, EPS)
        .to(torch.float32).sum(),
        "pallas noattrs": route(False, False),
        "pallas attrs": route(False, True),
    }


def measure(fn, o: V3, k_calls: int, dev) -> dict:
    """One variant's {"ms", "mrays_s", "k1_launches_per_call",
    "k2_launches_per_call", "peak_bytes"}."""
    res = time_calls(lambda i: fn(o), k_calls, [dev])
    dt = res.pop("seconds_per_call")
    return {"ms": dt * 1e3, "mrays_s": o.x.shape[0] / dt / 1e6, **res}


def main(argv=None) -> int:
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--rays", type=int, default=N_RAYS, help=f"rays per sweep (default {N_RAYS})")
    p.add_argument("--calls", type=int, default=K_CALLS, help=f"timed calls per variant (default {K_CALLS})")
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    args = p.parse_args(argv)
    dev = tool_device(args.device, "intersect_micro")
    if dev is None:
        return 1

    cfg = scene_config()
    scene = build_scene(cfg, build_color_tables(cfg, device=dev), device=dev)
    o, d = random_rays(scene, args.rays, seed=SEED)
    ign = torch.full((args.rays,), -1, dtype=torch.int32, device=dev)
    data = {"device": device_line(dev), "rays": args.rays, "results": []}
    failed = False
    print(f"{'variant':16s} {'ms':>10s} {'Mrays/s':>10s}  K1  K2  peak MB", flush=True)
    for name, fn in variants(scene, d, ign).items():
        res, err = guarded(name, measure, fn, o, args.calls, dev)
        if err:
            data["results"].append({"variant": name, "error": err})
            failed = True
            continue
        data["results"].append({"variant": name, **res})
        peak = "-" if res["peak_bytes"] is None else f"{res['peak_bytes'] / 1e6:.1f}"
        print(f"{name:16s} {res['ms']:10.4f} {res['mrays_s']:10.2f} {res['k1_launches_per_call']:3d} "
              f"{res['k2_launches_per_call']:3d}  {peak}", flush=True)
        write_json(args.out, data)
    write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
