"""The colour pipelines' texel formats on the card: u32 texels against f32
rows, and each configuration with its texture taken out (PyTorch port of
``tools/perf_modes_r05.py`` with ``tools/perf_modes_r04.py``'s ``bench``
and ``untexture``).

    python -m simple_spectral_torch.tools.perf_modes [out.json] [cfg-filter] [--fwd] [--lanes 262144]
        [--calls 16] [--size S] [--max-depth D] [--device cpu]

Configurations, as in the JAX tool: cfg4-jakob (plane-srgb 512x512, no
explicit light sampling), cfg3-meng (cornell-srgb 256x256, CIE 2006) and
cfg2-mallett (cornell-srgb 256x256), each in ``texel_format`` "u32" and
"rows" (mallett has no rows format), then a NOTEX row: the last format's
configuration and scene with every material's albedo kind constant and no
texture (``untexture``, ``tools/perf_modes_r04.py:38-47``).  A filter
keeps the configurations whose name contains it.

For each row, ``render`` (``_render_chunk`` at 1 spp) and ``fwd+bwd``
(``forward_backward_step`` at 1 spp), and with ``--fwd`` (the JAX tool's
``MODES_FWD=1``) ``fwd`` (``forward_only_step``) between them, on ``lanes``
pixels ``arange(lanes) % (w * h)`` and a zero target, the key
``fold_in(fold_in(PRNGKey(0), i), 0)`` for call i, timed by
``tools.time_calls`` (2 warm-up calls, then K = 16 between two
synchronizes, host clock).  A call counts ``lanes * (2 * depth - 1)`` rays
with explicit light sampling and ``lanes * depth`` without.

The file has the JAX tool's ``device`` (the card's name and power limit),
``lanes`` and ``results`` (``label``, ``ms``, ``mrays_s``); each result adds
the launches of K1 and K2 per call and the peak device memory, unrounded.
A timing that raises is written as ``{"label", "error"}``, the run goes on,
and the tool exits 1.  It runs on the card unless ``--device cpu`` is
given, and exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.scene.types import ALBEDO_CONSTANT
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

LANES = 262144
K_CALLS = 16
CONFIGS = {
    "cfg4-jakob": RenderConfig(scene="plane-srgb", mode="jakob", width=512, height=512, els=False),
    "cfg3-meng": RenderConfig(scene="cornell-srgb", mode="meng", observer=2006, width=256, height=256),
    "cfg2-mallett": RenderConfig(scene="cornell-srgb", mode="mallett", width=256, height=256),
}
FORMATS = ("u32", "rows")


def rows(which: str = "all") -> list:
    """(label, configuration, notex) of every row, in the JAX tool's order;
    a NOTEX row takes the configuration before it."""
    out = []
    for name, cfg0 in CONFIGS.items():
        if which != "all" and which not in name:
            continue
        for fmt in FORMATS:
            if "mallett" in name and fmt == "rows":
                continue  # mallett has no rows format
            cfg = cfg0.replace(texel_format=fmt)
            out.append((f"{name} [{fmt}]", cfg, False))
        out.append((f"{name} NOTEX", cfg, True))
    return out


def steps(fwd: bool = False) -> tuple:
    return ("render", "fwd", "fwd+bwd") if fwd else ("render", "fwd+bwd")


def pixels(cfg: RenderConfig, lanes: int, dev) -> torch.Tensor:
    return torch.arange(lanes, dtype=torch.int32, device=dev) % (cfg.width * cfg.height)


def rays_of(cfg: RenderConfig, lanes: int) -> int:
    return lanes * ((2 * cfg.max_depth - 1) if cfg.els else cfg.max_depth)


def untexture(scene):
    """Every material's albedo constant and no texture: the texel fetch
    and the texture's spectral upsampling leave the path."""
    kinds = torch.full_like(scene.materials.albedo_kind, ALBEDO_CONSTANT)
    mats = dataclasses.replace(scene.materials, albedo_kind=kinds)
    return dataclasses.replace(scene, materials=mats, texture=None)


def measure(label: str, step_name: str, scene, tables, cfg: RenderConfig, lanes: int, k_calls: int) -> dict:
    """One timing: {"label", "ms", "mrays_s", "k1_launches_per_call",
    "k2_launches_per_call", "peak_bytes"}."""
    from simple_spectral_torch.render.renderer import _render_chunk
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step

    dev = scene.device
    px = pixels(cfg, lanes, dev)
    target = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)
    key = rnd.PRNGKey(0)
    call = {"render": lambda k: _render_chunk(scene, tables, cfg, k, px, 1),
            "fwd": lambda k: forward_only_step(scene, tables, cfg, k, px, target, 1),
            "fwd+bwd": lambda k: forward_backward_step(scene, tables, cfg, k, px, target, 1)}[step_name]
    res = time_calls(lambda i: call(rnd.fold_in(rnd.fold_in(key, i), 0)), k_calls, [dev])
    dt = res.pop("seconds_per_call")
    return {"label": f"{label} {step_name}", "ms": dt * 1e3, "mrays_s": rays_of(cfg, lanes) / dt / 1e6, **res}


def main(argv=None) -> int:
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("args", nargs="*", metavar="[out.json] [cfg-filter]")
    p.add_argument("--fwd", action="store_true", help="time forward_only_step too (the JAX tool's MODES_FWD=1)")
    add_tool_args(p, lanes=LANES, calls=True)
    args = p.parse_args(argv)
    out = args.args[0] if args.args and args.args[0].endswith(".json") else None
    rest = args.args[1:] if out else args.args
    which = rest[0] if rest else "all"
    dev = tool_device(args.device, "perf_modes")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "lanes": args.lanes, "results": []}
    scene = None
    for label, cfg, notex in rows(which):
        cfg = cut(cfg, args)
        if notex:
            scene = untexture(scene)  # the format-independent texture branch, taken out once
        else:
            tables = build_color_tables(cfg, device=dev)
            scene = build_scene(cfg, tables, device=dev)
        for step_name in steps(args.fwd):
            res, err = guarded(f"{label} {step_name}", measure, label, step_name, scene, tables, cfg, args.lanes,
                               args.calls or K_CALLS)
            data["results"].append(res or {"label": f"{label} {step_name}", "error": err})
            if res:
                print(f"{res['label']:28s} {res['ms']:9.2f} ms  {res['mrays_s']:8.2f} Mrays/s  K1 "
                      f"{res['k1_launches_per_call']} K2 {res['k2_launches_per_call']} per call", flush=True)
            write_json(out, data)
    if out:
        print(f"wrote {out}", flush=True)
    return 1 if any("error" in r for r in data["results"]) else 0


if __name__ == "__main__":
    sys.exit(main())
