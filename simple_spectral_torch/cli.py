"""Command-line entry point of the PyTorch port.

The flag surface of ``simple_spectral_tpu/cli.py`` (reference
src/main.cpp:33-162 plus the runtime flags for what the reference fixes at
compile time), and ``--device``.  Flags whose code is not ported yet exit
non-zero with "not ported yet", naming the ROADMAP item.

    python -m simple_spectral_torch.cli --scene cornell-srgb -w 512 -h 512 -spp 4 -o out.png --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import ALL_MODES, RenderConfig, check_ported, not_ported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simple-spectral-torch",
        description="Differentiable spectral path tracer, PyTorch/CUDA port.",
        add_help=False,  # the reference's -h is height (src/main.cpp:44,107)
    )
    p.add_argument("--help", action="help", help="show this message and exit")
    p.add_argument("-s", "--scene", default="cornell-srgb",
                   help="cornell | cornell-srgb | plane-srgb | cornell-stress")
    p.add_argument("-w", "--width", type=int, default=512)
    p.add_argument("-h", "--height", type=int, default=512)
    p.add_argument("-spp", "--spp", "--samples", type=int, default=64,
                   help="samples per pixel (reference --samples/-spp)")
    p.add_argument("-o", "--output", default="output.png",
                   help="output path; format by extension: .png .pfm .hdr .csv")
    p.add_argument("-io", "--indirect-only", action="store_true",
                   help="render only indirect light (reference src/renderer.hpp:24)")
    p.add_argument("--mode", default="mallett", choices=ALL_MODES,
                   help="color pipeline (reference src/stdafx.hpp:63-93)")
    p.add_argument("--observer", type=int, default=1931, choices=(1931, 2006),
                   help="CIE standard observer (reference src/stdafx.hpp:82-86)")
    p.add_argument("--wavelengths", type=int, default=4,
                   help="hero wavelengths per path (reference SAMPLE_WAVELENGTHS)")
    p.add_argument("--max-depth", type=int, default=10,
                   help="max path depth incl. shadow rays (reference MAX_DEPTH)")
    p.add_argument("--no-els", action="store_true",
                   help="disable explicit light sampling (reference EXPLICIT_LIGHT_SAMPLING)")
    p.add_argument("--no-flat-field", action="store_true",
                   help="disable flat-field correction (reference FLAT_FIELD_CORRECTION)")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--texture", default="crystal-lizard-512.png",
                   help="texture for the srgb scenes")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--window", nargs="?", const="auto", default=None,
                   choices=("auto", "http", "ansi"), metavar="KIND",
                   help="live preview of the accumulating image (not ported yet)")
    p.add_argument("--window-port", type=int, default=8000)
    p.add_argument("--sp", type=int, default=1, metavar="K",
                   help="sample-parallel mesh axis (not ported yet)")
    p.add_argument("--sharded", action="store_true", help="mesh rendering (not ported yet)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host rendering (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--intersect-impl", default="auto",
                   choices=("auto", "xla", "xla2", "pallas", "bvh", "cull"),
                   help="closest-hit implementation; every dense name runs the K1 kernel")
    p.add_argument("--stress-boxes", type=int, default=1000)
    p.add_argument("--stress-spheres", type=int, default=500)
    p.add_argument("--debug-checks", action="store_true", help="finite checks (not ported yet)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="progressive checkpointed render (not ported yet)")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="N")
    p.add_argument("--pass-spp", type=int, default=4)
    p.add_argument("--metrics-json", default=None, metavar="PATH")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def _refuse_unported(args) -> None:
    if args.sharded or args.sp > 1 or args.coordinator or args.num_processes:
        raise not_ported("--sharded/--sp/--coordinator", 14)
    if args.window:
        raise not_ported("--window", 15)
    if args.checkpoint:
        raise not_ported("--checkpoint", 15)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        _refuse_unported(args)
        cfg = RenderConfig(
            scene=args.scene, width=args.width, height=args.height, spp=args.spp,
            indirect_only=args.indirect_only, mode=args.mode, observer=args.observer,
            n_wavelengths=args.wavelengths, max_depth=args.max_depth, els=not args.no_els,
            flat_field=not args.no_flat_field, texture=args.texture,
            intersect_impl=args.intersect_impl, debug_checks=args.debug_checks,
            stress_boxes=args.stress_boxes, stress_spheres=args.stress_spheres,
        )
        check_ported(cfg)
        if cfg.scene in ("plane-srgb", "cornell-stress"):
            raise not_ported(f"scene {cfg.scene!r}", 10 if cfg.scene == "plane-srgb" else 13)
        device = resolve_device(args.device)
    except (NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if cfg.scene.startswith("cornell") and not cfg.els:
        print("Warning: Cornell converges much faster with explicit light sampling!", file=sys.stderr)

    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.render.renderer import render_image

    t0 = time.time()
    fb = render_image(cfg, seed=args.seed, progress=not args.quiet, device=device)
    dt = time.time() - t0
    save_image(args.output, fb)
    if not args.quiet:
        rays = cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth - 1 if cfg.els else cfg.max_depth)
        print(f"rendered {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp mode={cfg.mode} on {args.device} "
              f"in {dt:.2f}s ({rays / dt / 1e6:.2f} Mrays/s) -> {args.output}")
    if args.metrics_json:
        import json

        line = json.dumps({"scene": cfg.scene, "width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                           "mode": cfg.mode, "device": args.device, "seconds": dt})
        if args.metrics_json == "-":
            print(line)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
