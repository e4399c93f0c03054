"""Forward render time of two checkouts of the port, in turns, on one card.

    python -m simple_spectral_torch.ab_render --parent DIR [--scene cornell-srgb] [--spp 1] [--renders 5]

DIR is another checkout's root (for instance ``git archive <commit>
simple_spectral_torch simple_spectral_tpu/data`` unpacked there).  Runs
profile_render's configuration of ``--scene`` at 512x512 with the parent,
this checkout, this checkout and the parent, each in a fresh process that
builds its own kernels, renders once to warm up and then ``--renders``
times, and prints one JSON line per process: the checkout, the render
seconds and the forward Mrays/s of their median (19 rays per sample).  A
checkout that cannot render the configuration prints its error and makes
the exit code 1.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from simple_spectral_torch.profile_render import CONFIGS

_CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import simple_spectral_torch
assert simple_spectral_torch.__file__.startswith(sys.argv[1]), simple_spectral_torch.__file__
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.renderer import render_image
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables
cfg = RenderConfig(width=512, height=512, **json.loads(sys.argv[2]))
dev = torch.device("cuda")
tables = build_color_tables(cfg, device=dev)
scene = build_scene(cfg, tables, device=dev)
render_image(cfg, scene, tables, device=dev)
torch.cuda.synchronize()
secs = []
for _ in range(int(sys.argv[3])):
    t0 = time.perf_counter()
    render_image(cfg, scene, tables, device=dev)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
rays = cfg.width * cfg.height * cfg.spp * 19
print(json.dumps({"checkout": sys.argv[1], "seconds": secs, "mrays": rays / statistics.median(secs) / 1e6}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the other checkout")
    p.add_argument("--scene", choices=sorted(CONFIGS), default="cornell-srgb")
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--renders", type=int, default=5)
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(args.parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.scene}: parent {parent} vs {here} on {card}")
    rc = 0
    for root in (parent, here, here, parent):
        config = json.dumps(dict(CONFIGS[args.scene], spp=args.spp))
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, config, str(args.renders)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            rc = 1
        print(proc.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
