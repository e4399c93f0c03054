"""BASELINE configuration 5 end to end: cornell-srgb 1024x1024 at 256 spp in
all four colour pipelines, through ``render_accumulate_sharded`` (PyTorch
port of ``tools/cfg5_r05.py``).

    python -m simple_spectral_torch.tools.cfg5 [out.json] [card|cpu|all] [--modes rgb,mallett,meng,jakob]
        [--size S] [--spp N] [--max-depth D] [--device cpu]

Two parts, as in the JAX tool:

1. ``card`` (the JAX tool's ``tpu``): the full-size render on ``make_mesh()``
   (every local card, all on dp; one card: the 1x1 mesh), for each mode:
   ``chunk_px = min(n_px, render_chunk_lanes * dp)`` pixels a chunk,
   ``n_chunks``, the wall time of the render (host clock; its result is on
   the host when it returns), Mrays/s at ``n_px * spp * (2 * depth - 1)``
   rays, and the means of the value and of alpha
   (``tools/cfg5_r05.py:39-77``).  K1 is built before the first render,
   so no row times a build.  Each row adds K1's and K2's launches in the
   render and the peak device memory.
2. ``cpu``: the same frame (mallett, 2 spp, ``max_lanes = 2^18``) through
   the sharded chunk loop on an 8-device CPU mesh (``make_mesh(["cpu"] *
   8)``, dp = 8) against ``render_accumulate``, seed 5 for both; the
   sharded streams fold in the shard index, so the two are different
   estimates of one image, and the check is ``dm < 0.02 and da < 0.01`` on
   the relative difference of the value means and the difference of the
   alpha means (``tools/cfg5_r05.py:80-130``).

``all`` (the default) runs both in one process: the JAX tool has to start
twice because JAX cannot switch platforms.  A mode that raises is written
as ``{"mode", "error"}``, and a failed or raising check as ``cpu_check``
with ``pass`` false or an ``error``; the run goes on, and the tool exits 1.
The file has the JAX tool's ``configs``, ``device`` (the card's name and
power limit, or "cpu") and ``cpu_check``, unrounded; an existing file's
other part is kept.  The card part runs on the card unless ``--device cpu``
is given, and exits 1 without one; ``--size``, ``--spp`` (both parts) and
``--max-depth`` cut the frame to check the program at a small size.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import add_tool_args, cut, guarded, tool_device, write_json

MODES = ("rgb", "mallett", "meng", "jakob")
PARTS = ("card", "cpu", "all")
CARD_SPP, CPU_SPP = 256, 2
CPU_DP, CPU_SEED = 8, 5
CPU_MAX_LANES = 1 << 18
# the check of the sharded render against the unsharded one
MEAN_RTOL, ALPHA_ATOL = 0.02, 0.01


def card_config(mode: str) -> RenderConfig:
    return RenderConfig(scene="cornell-srgb", mode=mode, width=1024, height=1024, spp=CARD_SPP)


def cpu_config() -> RenderConfig:
    return RenderConfig(scene="cornell-srgb", mode="mallett", width=1024, height=1024, spp=CPU_SPP,
                        max_lanes=CPU_MAX_LANES)


def chunk_px(cfg: RenderConfig, scene, dp: int) -> int:
    """Pixels of one chunk of ``render_accumulate_sharded`` (before its
    rounding to a multiple of dp), as the JAX tool counts them."""
    from simple_spectral_torch.render.renderer import render_chunk_lanes

    return min(cfg.width * cfg.height, render_chunk_lanes(cfg, scene) * dp)


def rays_of(cfg: RenderConfig) -> float:
    return float(cfg.width * cfg.height) * cfg.spp * (2 * cfg.max_depth - 1)


def check_passes(mean_rel_diff: float, alpha_mean_diff: float) -> bool:
    return bool(mean_rel_diff < MEAN_RTOL and alpha_mean_diff < ALPHA_ATOL)


def card_row(cfg: RenderConfig, mesh, dev) -> dict:
    """One mode's render on ``mesh``: the JAX tool's row, with launches and
    peak memory."""
    import torch

    from simple_spectral_torch.parallel.sharding import render_accumulate_sharded
    from simple_spectral_torch.render import cull as k2
    from simple_spectral_torch.render import intersect_pallas as k1
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    n_px = cfg.width * cfg.height
    chunk = chunk_px(cfg, scene, mesh.shape["dp"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
    t0 = time.perf_counter()
    value, alpha = render_accumulate_sharded(cfg, scene, tables, mesh)
    wall = time.perf_counter() - t0
    row = {"mode": cfg.mode, "width": cfg.width, "spp": cfg.spp, "mesh": dict(mesh.shape), "chunk_px": chunk,
           "n_chunks": -(-n_px // chunk), "wall_s": wall, "mrays_s": rays_of(cfg) / wall / 1e6,
           "value_mean": [float(m) for m in value.mean(axis=(0, 1))], "alpha_mean": float(alpha.mean()),
           "k1_launches": k1.LAUNCHES - k1_before, "k2_launches": k2.LAUNCHES - k2_before,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None}
    if not all(math.isfinite(m) for m in row["value_mean"] + [row["alpha_mean"]]):
        raise FloatingPointError(f"{cfg.mode}: the image's means are not finite: {row}")
    return row


def run_card(data: dict, args, dev) -> bool:
    """The card part; returns whether every mode rendered."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.parallel.sharding import make_mesh
    from simple_spectral_torch.render import intersect_pallas as k1

    data["device"] = device_line(dev)
    mesh = make_mesh() if dev.type == "cuda" else make_mesh([dev])
    if dev.type == "cuda":
        kernels.build(k1.SOURCE)
    ok = True
    for mode in args.modes.split(","):
        cfg = cut(card_config(mode), args)
        cfg = cfg.replace(spp=args.spp or cfg.spp)
        row, err = guarded(f"cfg5 {mode}", card_row, cfg, mesh, dev)
        data["configs"].append(row or {"mode": mode, "error": err})
        ok = ok and err is None
        print(row or {"mode": mode, "error": err}, flush=True)
        write_json(args.out, data)
    return ok


def cpu_check(cfg: RenderConfig) -> dict:
    """The sharded chunk loop on an 8-device CPU mesh against the unsharded
    render."""
    from simple_spectral_torch.parallel.sharding import make_mesh, render_accumulate_sharded
    from simple_spectral_torch.render.renderer import render_accumulate
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device="cpu")
    scene = build_scene(cfg, tables, device="cpu")
    mesh = make_mesh(["cpu"] * CPU_DP, dp=CPU_DP)
    t0 = time.perf_counter()
    v_sh, a_sh = render_accumulate_sharded(cfg, scene, tables, mesh, seed=CPU_SEED)
    sh_s = time.perf_counter() - t0
    v_un, a_un = render_accumulate(cfg, scene, tables, seed=CPU_SEED)
    dm = float(abs(v_sh.mean() - v_un.mean()) / max(abs(v_un.mean()), 1e-9))
    da = float(abs(a_sh.mean() - a_un.mean()))
    n_px = cfg.width * cfg.height
    return {"check": f"cpu dp={CPU_DP} sharded chunk loop vs unsharded, {cfg.width}^2 @ {cfg.spp} spp",
            "n_chunks": -(-n_px // chunk_px(cfg, scene, CPU_DP)), "sharded_wall_s": sh_s,
            "mean_rel_diff": dm, "alpha_mean_diff": da, "pass": check_passes(dm, da)}


def run_cpu(data: dict, args) -> bool:
    """The CPU part; returns whether the check ran and passed."""
    cfg = cut(cpu_config(), args)
    cfg = cfg.replace(spp=args.spp or cfg.spp)
    row, err = guarded("cfg5 cpu check", cpu_check, cfg)
    data["cpu_check"] = row or {"check": "cpu sharded chunk loop vs unsharded", "error": err, "pass": False}
    print(data["cpu_check"], flush=True)
    write_json(args.out, data)
    return data["cpu_check"]["pass"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("args", nargs="*", metavar="[out.json] [card|cpu|all]",
                   help="the JSON file to write (an existing one is merged into), and the part (default all)")
    p.add_argument("--modes", default=",".join(MODES), help="the card part's modes, comma-separated")
    p.add_argument("--spp", type=int, default=None, help=f"samples per pixel (default {CARD_SPP} on the card, "
                                                          f"{CPU_SPP} in the CPU check)")
    add_tool_args(p)
    args = p.parse_args(argv)
    args.out = args.args[0] if args.args and args.args[0].endswith(".json") else None
    rest = args.args[1:] if args.out else args.args
    if len(rest) > 1 or (rest and rest[0] not in PARTS):
        p.error(f"expected [out.json] [{'|'.join(PARTS)}], got {' '.join(args.args)}")
    args.part = rest[0] if rest else "all"
    dev = None
    if args.part != "cpu":
        dev = tool_device(args.device, "cfg5")
        if dev is None:
            return 1
    data = {"configs": []}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            data = json.load(f)
        data.setdefault("configs", [])
    ok = True
    if args.part in ("card", "all"):
        ok = run_card(data, args, dev) and ok
    if args.part in ("cpu", "all"):
        ok = run_cpu(data, args) and ok
    write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
