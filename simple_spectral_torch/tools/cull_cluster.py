"""Cluster size of the block cull (K2) at 5000 boxes, end to end (PyTorch
port of ``tools/bench_cull_cluster.py``).

    python -m simple_spectral_torch.tools.cull_cluster [out.json] [--sizes 63,31,15] [--boxes 5000]
        [--lanes 262144] [--calls 5] [--size S] [--max-depth D] [--device cpu]

The JAX tool's configuration (``tools/bench_cull_cluster.py:19-37``): one
``_render_chunk`` of 262144 pixels (``arange``) at 1 spp on cornell-stress,
rgb, 512x512, depth 10, explicit light sampling, 5000 boxes and 250
spheres, ``intersect_impl="cull"``, with the scene's clusters built at
``cull_cluster_size`` L = 63, 31 and 15 (tiles of 1 + L rows), call i on the
key ``fold_in(fold_in(PRNGKey(0), i), 0)``, timed by ``tools.time_calls``
(2 warm-up calls, then K = 5 between two synchronizes, host clock).  The
JAX tool found 63 fastest on a TPU (``tools/cull_cluster_exp_r05.json``);
this measures the card.

Each row keeps the JAX tool's ``cluster_size``, ``clusters`` and ``ms``,
and adds ``k1_launches_per_call``, ``k2_launches_per_call`` and
``peak_bytes``; a size that raises leaves ``error``, and the tool exits 1.
The JAX tool writes a bare list of rows, to ``/tmp`` when given no path;
this writes ``{"device", "results"}`` (the card's name and power limit, the
same rows, unrounded), and nothing without a path.  It runs on the card
unless ``--device cpu`` is given, and exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

SIZES = (63, 31, 15)
BOXES = 5000
LANES = 262144
K_CALLS = 5


def cluster_config(cluster_size: int, boxes: int = BOXES) -> RenderConfig:
    return RenderConfig(scene="cornell-stress", mode="rgb", width=512, height=512, stress_boxes=boxes,
                        stress_spheres=boxes // 20, intersect_impl="cull", cull_cluster_size=cluster_size)


def call_key(i: int):
    """Call i's key: the JAX tool's ``fold_in(fold_in(PRNGKey(0), i), tok)``
    with its chain token, 0 for any finite output."""
    return rnd.fold_in(rnd.fold_in(rnd.PRNGKey(0), i), 0)


def measure(cluster_size: int, args, dev) -> dict:
    """One cluster size's row."""
    from simple_spectral_torch.render.renderer import _render_chunk
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = cut(cluster_config(cluster_size, args.boxes), args)
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    px = torch.arange(args.lanes, dtype=torch.int32, device=dev)
    res = time_calls(lambda i: _render_chunk(scene, tables, cfg, call_key(i), px, 1), args.calls or K_CALLS, [dev])
    return {"cluster_size": cluster_size, "clusters": int(scene.cull_tiles.shape[0]),
            "ms": res.pop("seconds_per_call") * 1e3, **res}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--sizes", default=",".join(map(str, SIZES)), help="cluster sizes L, comma-separated")
    p.add_argument("--boxes", type=int, default=BOXES, help=f"stress boxes (default {BOXES})")
    add_tool_args(p, lanes=LANES, calls=True)
    args = p.parse_args(argv)
    dev = tool_device(args.device, "cull_cluster")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "results": []}
    failed = False
    for size in (int(s) for s in args.sizes.split(",")):
        row, err = guarded(f"cluster_size={size}", measure, size, args, dev)
        if err:
            row = {"cluster_size": size, "error": err}
            failed = True
        else:
            print(f"cluster_size={size}: {row['clusters']} clusters, {row['ms']:.4f} ms per call, K2 "
                  f"{row['k2_launches_per_call']} per call", flush=True)
        data["results"].append(row)
        write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
