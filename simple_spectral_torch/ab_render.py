"""Forward render time, or one kernel's time, of two checkouts of the port,
in turns, on one card.

    python -m simple_spectral_torch.ab_render --parent DIR [--scene cornell-srgb] [--spp 1] [--renders 5]
    python -m simple_spectral_torch.ab_render --parent DIR --kernel k1|k2|s1|gather [--reps 100]

DIR is another checkout's root (for instance ``git archive <commit>
simple_spectral_torch simple_spectral_tpu/data`` unpacked there).  Each
checkout runs in a fresh process that builds its own kernels, in the order
parent, this checkout, this checkout, parent, and prints one JSON line.

Without ``--kernel`` each process renders profile_render's configuration of
``--scene`` at 512x512 once to warm up and then ``--renders`` times; its
line holds the render seconds and the forward Mrays/s of their median (19
rays per sample).

``--kernel k1`` times one bounce sweep of K1 on cornell-srgb as the render
calls it (``intersect_best_key`` on V3 rays, exact key, any copy the
checkout makes of the rays included), ``--kernel k2`` one sorted bounce
sweep of K2 on cornell-stress, ``--kernel s1`` one fused bounce of S1 on
262144 camera rays of cornell, and ``--kernel gather`` one gather_u32 over
the real texel-fetch indices of a cornell-srgb sample (the inputs of this
checkout's ``tools/sweeps.py``, built with the timed checkout's package); each with this checkout's
``tools.cuda_time_ms`` (the card's time alone, ``--reps`` launches behind a
device spin, the L2 warm), whichever checkout's kernel it times.  The line
holds the milliseconds per launch and a digest of the kernel's output, which
must be the same in both checkouts.

A checkout that fails prints its error and makes the exit code 1.  Needs a
CUDA device.
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

_KERNEL_CHILD = r"""
import hashlib, importlib.util, json, os, sys
root, here, kernel, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
sys.path.insert(0, root)
import torch
import simple_spectral_torch
assert simple_spectral_torch.__file__.startswith(root), simple_spectral_torch.__file__


def here_module(name):  # a module of this checkout, whichever checkout's package it then uses
    spec = importlib.util.spec_from_file_location("ab_" + name, os.path.join(here, "simple_spectral_torch", "tools",
                                                                            name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


timer, sweeps = here_module("__init__"), here_module("sweeps")
dev = torch.device("cuda")
if kernel == "k1":
    from simple_spectral_torch.render import intersect_pallas
    args = sweeps.k1_bounce_sweep(dev)
    fn = lambda: intersect_pallas.intersect_best_key(**args)
elif kernel == "k2":
    from simple_spectral_torch.render import cull
    args = sweeps.k2_bounce_sweep(dev)
    fn = lambda: cull.cull_best_cuda(**args)
elif kernel == "s1":
    from simple_spectral_torch.tools import bench_megakernel
    args = sweeps.s1_bounce(dev)
    fn = lambda: bench_megakernel.bounce_cuda(**args)
else:
    from simple_spectral_torch.tools import bench_gather
    args = sweeps.texel_gather(dev)
    fn = lambda: bench_gather.gather_u32_cuda(**args)
digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
ms = timer.cuda_time_ms(fn, reps)
print(json.dumps({"checkout": root, "kernel": kernel, "ms": ms, "reps": reps, "output_sha256": digest}))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="root of the other checkout")
    p.add_argument("--scene", choices=sorted(CONFIGS), default="cornell-srgb")
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--renders", type=int, default=5)
    p.add_argument("--kernel", choices=("k1", "k2", "s1", "gather"), help="time one kernel instead of a render")
    p.add_argument("--reps", type=int, default=100, help="launches of --kernel timed back to back")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parent = os.path.abspath(args.parent)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    what = f"kernel {args.kernel}" if args.kernel else args.scene
    print(f"{what}: parent {parent} vs {here} on {card}")
    rc = 0
    for root in (parent, here, here, parent):
        if args.kernel:
            cmd = [_KERNEL_CHILD, root, here, args.kernel, str(args.reps)]
        else:
            cmd = [_CHILD, root, json.dumps(dict(CONFIGS[args.scene], spp=args.spp)), str(args.renders)]
        proc = subprocess.run([sys.executable, "-c", *cmd], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            rc = 1
        print(proc.stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
