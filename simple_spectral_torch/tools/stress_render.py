"""Stress-scene render throughput, the block cull (K2) against the dense
sweep (K1), through the whole integrator (PyTorch port of
``tools/bench_stress_render.py``).

    python -m simple_spectral_torch.tools.stress_render [out.json] [--boxes 1000,5000,10000] [--lanes 262144]
        [--calls 6] [--size S] [--max-depth D] [--device cpu]

The JAX tool's configuration (``tools/bench_stress_render.py:46-75``):
cornell-stress, rgb, 512x512, depth 10, explicit light sampling, at each
box count with ``stress_spheres = boxes // 20``.  Each arm, ``cull`` (K2)
and ``xla`` (K1's exact key, spheres merged in torch), times one
``_render_chunk`` of ``lanes`` pixels (``arange``) at 1 spp with the key
``fold_in(fold_in(PRNGKey(0), i), 0)`` for call i, through
``tools.time_calls`` (2 warm-up calls, then K = 6 between two
synchronizes, host clock).  The dense arm is skipped above 60000
triangles, as in the JAX tool.  A call counts ``lanes * (2 * depth - 2)``
rays: the sweeps it makes (the last bounce's shadow sweep is skipped).

Each row keeps the JAX tool's ``boxes``, ``tris``, ``clusters``,
``{arm}_ms`` and ``{arm}_mrays_s``, and adds ``{arm}_k1_launches_per_call``,
``{arm}_k2_launches_per_call`` and ``{arm}_peak_bytes``; an arm that raises
leaves ``{arm}_error``, the run goes on, and the tool exits 1.  The file
has the JAX tool's ``device`` (the card's name and power limit) and
``results``, unrounded.  It runs on the card unless ``--device cpu`` is
given, and exits 1 without one.  The scene's auto threshold
(``render/intersect.py`` ``CULL_AUTO_THRESHOLD``) is the TPU's crossover;
this tool measures the card's.
"""

from __future__ import annotations

import argparse
import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

BOXES = (1000, 5000, 10000)
LANES = 262144
K_CALLS = 6
ARMS = ("cull", "xla")
# the JAX tool times no dense render above this many triangles (~9 s a call
# on the TPU at 100k)
DENSE_MAX_TRIS = 60000


def stress_config(boxes: int) -> RenderConfig:
    return RenderConfig(scene="cornell-stress", mode="rgb", width=512, height=512, stress_boxes=boxes,
                        stress_spheres=boxes // 20, intersect_impl="cull", max_depth=10)


def arms(n_tris: int) -> list:
    """The arms timed on a scene of ``n_tris`` triangles."""
    return [a for a in ARMS if not (a == "xla" and n_tris > DENSE_MAX_TRIS)]


def rays_of(cfg: RenderConfig, lanes: int) -> int:
    """Sweeps of one call, as the JAX tool counts them."""
    return lanes * (2 * cfg.max_depth - 2)


def measure(scene, tables, cfg: RenderConfig, lanes: int, k_calls: int) -> dict:
    """One arm's {"ms", "mrays_s", "k1_launches_per_call",
    "k2_launches_per_call", "peak_bytes"}."""
    from simple_spectral_torch.render.renderer import _render_chunk

    dev = scene.device
    px = torch.arange(lanes, dtype=torch.int32, device=dev)
    key = rnd.PRNGKey(0)

    def step(i):
        return _render_chunk(scene, tables, cfg, rnd.fold_in(rnd.fold_in(key, i), 0), px, 1)

    res = time_calls(step, k_calls, [dev])
    dt = res.pop("seconds_per_call")
    return {"ms": dt * 1e3, "mrays_s": rays_of(cfg, lanes) / dt / 1e6, **res}


def main(argv=None) -> int:
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--boxes", default=",".join(map(str, BOXES)), help="box counts, comma-separated")
    add_tool_args(p, lanes=LANES, calls=True)
    args = p.parse_args(argv)
    dev = tool_device(args.device, "stress_render")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "results": []}
    failed = False
    for boxes in (int(b) for b in args.boxes.split(",")):
        cfg0 = cut(stress_config(boxes), args)
        tables = build_color_tables(cfg0, device=dev)
        scene = build_scene(cfg0, tables, device=dev)
        row = {"boxes": boxes, "tris": scene.n_tris, "clusters": int(scene.cull_tiles.shape[0])}
        for arm in arms(scene.n_tris):
            res, err = guarded(f"boxes={boxes} {arm}", measure, scene, tables, cfg0.replace(intersect_impl=arm),
                               args.lanes, args.calls or K_CALLS)
            if err:
                row[f"{arm}_error"] = err
                failed = True
                continue
            row.update({f"{arm}_{k}": v for k, v in res.items()})
            print(f"boxes={boxes} {arm}: {res['ms']:.1f} ms ({res['mrays_s']:.2f} Mrays/s), K1 "
                  f"{res['k1_launches_per_call']} K2 {res['k2_launches_per_call']} per call", flush=True)
        data["results"].append(row)
        write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
