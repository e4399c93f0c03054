"""Command-line entry point of the PyTorch port.

The flag surface of ``simple_spectral_tpu/cli.py`` (reference
src/main.cpp:33-162 plus the runtime flags for what the reference fixes at
compile time), and ``--device``.  As in the JAX package, every render runs
through the progressive renderer (``render/progressive.py``): passes of
``--pass-spp`` samples, ``--checkpoint`` with resume, the ``--window`` live
preview and ``--metrics-json``.  ``--sharded`` and ``--sp K`` render those
passes on a (dp, sp) mesh of this process's devices (``parallel/``);
``--coordinator HOST:PORT --num-processes N --process-id I`` renders one
image across N processes (NCCL on the card, gloo with ``--device cpu``),
which process 0 writes.

    python -m simple_spectral_torch.cli --scene cornell-srgb -w 512 -h 512 -spp 8 --pass-spp 4 \
        --checkpoint render.ckpt --metrics-json - -o out.png --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import ALL_MODES, RenderConfig


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
                   help="live preview of the accumulating image: http (browser, default) or ansi "
                   "(truecolor terminal)")
    p.add_argument("--window-port", type=int, default=8000, help="port for --window http (0 = ephemeral)")
    p.add_argument("--sp", type=int, default=1, metavar="K",
                   help="sample-parallel mesh axis: samples per pixel split over K devices (implies --sharded)")
    p.add_argument("--sharded", action="store_true",
                   help="render on a (dp, sp) mesh of this process's devices (pixels on dp)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process rendering: the address of process 0 (with --num-processes and --process-id)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--intersect-impl", default="auto",
                   choices=("auto", "xla", "xla2", "pallas", "bvh", "cull"),
                   help="closest-hit implementation: auto = the block-cull kernel K2 from 32768 "
                   "primitives on, else K1, which every other dense name runs; bvh = the stackless "
                   "skip-link BVH walk")
    p.add_argument("--stress-boxes", type=int, default=1000,
                   help="cornell-stress: random boxes (10 triangles each)")
    p.add_argument("--stress-spheres", type=int, default=500, help="cornell-stress: random spheres")
    p.add_argument("--debug-checks", action="store_true",
                   help="check every op of the render for NaN and division by zero; the first failure "
                   "raises with its op and place (slow; a debugging aid)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint the accumulation to PATH; resumes automatically if PATH exists")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="N", help="checkpoint every N passes")
    p.add_argument("--pass-spp", type=int, default=4, help="samples per pixel per progressive pass")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write render metrics as one JSON line to PATH ('-' = stdout)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def _mesh_devices(device):
    """This process's devices for a mesh: every local card for ``cuda``,
    else the one device named."""
    return None if device.type == "cuda" and device.index is None else [device]


def _render_multihost(args, cfg: RenderConfig, device) -> int:
    """One image across every process of the group, written by process 0
    (no progressive passes, as in the JAX package)."""
    import torch.distributed as dist

    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.parallel.multihost import process_index, render_accumulate_multihost
    from simple_spectral_torch.render.renderer import finalize_srgb
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    t0 = time.time()
    tables = build_color_tables(cfg, device=device)
    scene = build_scene(cfg, tables, device=device)
    try:
        value, alpha = render_accumulate_multihost(cfg, scene, tables, sp=args.sp, seed=args.seed,
                                                   local_devices=_mesh_devices(device))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.time() - t0
    if process_index() == 0:
        save_image(args.output, finalize_srgb(cfg, tables, value, alpha))
    if not args.quiet:
        print(f"rendered {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp mode={cfg.mode} on "
              f"{dist.get_world_size()} processes ({device}) in {dt:.2f}s -> {args.output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    multihost = bool(args.coordinator or args.num_processes)
    try:
        cfg = RenderConfig(
            scene=args.scene, width=args.width, height=args.height, spp=args.spp,
            indirect_only=args.indirect_only, mode=args.mode, observer=args.observer,
            n_wavelengths=args.wavelengths, max_depth=args.max_depth, els=not args.no_els,
            flat_field=not args.no_flat_field, texture=args.texture,
            intersect_impl=args.intersect_impl, debug_checks=args.debug_checks,
            stress_boxes=args.stress_boxes, stress_spheres=args.stress_spheres,
        )
        device = resolve_device(args.device)
        owns_group = False
        if multihost:
            from simple_spectral_torch.parallel.multihost import init_distributed

            # joins the process group before any device work
            owns_group = init_distributed(args.coordinator, args.num_processes, args.process_id, device=device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # the reference's convergence advice (src/renderer.cpp:18-31)
    if cfg.scene.startswith("cornell") and not cfg.els:
        print("Warning: Cornell converges much faster with explicit light sampling!", file=sys.stderr)
    if cfg.scene == "plane-srgb" and cfg.els:
        print("Warning: Plane converges much faster without explicit light sampling!", file=sys.stderr)

    if multihost:
        try:
            return _render_multihost(args, cfg, device)
        finally:
            if owns_group:
                import torch.distributed as dist

                dist.destroy_process_group()

    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.render.progressive import ProgressiveRenderer

    t0 = time.time()
    try:
        mesh = None
        if args.sharded or args.sp > 1:
            # a mesh of this process's devices rides the progressive renderer,
            # so --sharded composes with --checkpoint and --window
            from simple_spectral_torch.parallel.sharding import make_mesh

            mesh = make_mesh(_mesh_devices(device), sp=args.sp)
        pr = ProgressiveRenderer(cfg, seed=args.seed, checkpoint_path=args.checkpoint,
                                 spp_per_pass=args.pass_spp, mesh=mesh, device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.checkpoint and pr.resume():
        print(f"resumed from {args.checkpoint} at {pr.spp_done} spp", file=sys.stderr)
    preview = on_pass = None
    if args.window:
        from simple_spectral_torch.io.preview import open_preview

        preview = open_preview(args.window, port=args.window_port, quiet=args.quiet)
        on_pass = lambda p: preview.update(p.image_u8(), p.spp_done, cfg.spp)  # noqa: E731
    try:
        pr.run(checkpoint_every=args.checkpoint_every, progress=not args.quiet, on_pass=on_pass)
    finally:
        if preview is not None:
            preview.close()
    dt = time.time() - t0
    save_image(args.output, pr.image())
    if not args.quiet:
        print(f"rendered {cfg.scene} {cfg.width}x{cfg.height}@{pr.spp_done}spp mode={cfg.mode} on {device} "
              f"in {dt:.2f}s ({pr.metrics.mrays_per_s:.2f} Mrays/s) -> {args.output}")
    if args.metrics_json:
        line = pr.metrics.to_json()
        if args.metrics_json == "-":
            print(line)
        else:
            with open(args.metrics_json, "w") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
