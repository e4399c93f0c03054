#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  In order, it

1. prints the card's name and power limit and builds kernel K1
   (simple_spectral_torch/csrc/intersect_best_key.cu) from source;
2. holds K1 key for key against its plain PyTorch twin on the card, on
   seeded random rays inside the cornell-srgb bounds and on real camera and
   bounce rays, at N in {1, 7, 2049, 262144}, with the ignored primitive on
   and off, and times both at N = 262144 beside the kernel's bound;
3. renders cornell-srgb at 512x512 (mallett, CIE 1931, 4 hero wavelengths,
   depth 10, explicit light sampling, 4 spp) through ``render_image`` on the
   card, checks K1's launch count (18 sweeps per sample and chunk), a finite
   framebuffer and the alpha coverage, writes the PNG under
   simple_spectral_torch/_build/ and prints the forward Mrays/s (19 rays per
   sample, as bench.py counts them);
4. renders a 16x16, 2 spp frame from the same key on the card (through K1)
   and on the CPU (through the twin) and holds the two within the flip bound
   of tests/test_parallel.py;
5. prints one JSON line describing every kernel, then the result line.

Any failure exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# non-tensor FP32 throughput.
H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
# FP32 operations K1 runs for every (ray, triangle) pair whatever the data:
# 9 (v - o) + 12 shear + 9 barycentrics + 2 det + 6 scaled distance.  The
# one division of each candidate that passes the edge test is left out, so
# the bound is a floor.
K1_OPS_PER_TEST = 38

SPP = 4
WIDTH = HEIGHT = 512


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, torch) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ray_sets(torch, np, scene, cfg, n_max: int):
    """Seeded random rays inside the scene bounds, camera rays, and bounce
    rays leaving the camera hits (with their primitive ignored); each a
    tuple (o V3, d V3, ignore i32[N]) of CUDA tensors with N = n_max."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.render.integrator import camera_rays_soa
    from simple_spectral_torch.render.intersect import intersect_rays_dispatch
    from simple_spectral_torch.render.vec import V3

    dev = scene.device
    rng = np.random.default_rng(7)
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=(n_max, 3)).astype(np.float32)
    d = rng.normal(size=(n_max, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    prims = rng.integers(-1, scene.n_prims, size=n_max).astype(np.int32)

    def v3(a):
        return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev) for i in range(3)))

    sets = {"random": (v3(o), v3(d), torch.from_numpy(prims).to(dev))}
    # pixels in a prime-stride order, so that the short prefixes (N = 1, 7,
    # 2049) spread over the whole image instead of its bottom rows
    px = (torch.arange(n_max, dtype=torch.int64, device=dev) * 7919 % (cfg.width * cfg.height)).to(torch.int32)
    co, cd = camera_rays_soa(scene, cfg, rnd.PRNGKey(1), px % cfg.width, px // cfg.width)
    co = V3(*(c.contiguous() for c in co))
    sets["camera"] = (co, cd, torch.full((n_max,), -1, dtype=torch.int32, device=dev))
    rec = intersect_rays_dispatch(scene, co, cd, sets["camera"][2], cfg.eps)
    dist = torch.where(torch.isfinite(rec.dist), rec.dist, 0.0)
    bo = co + cd * dist
    bd = rng.normal(size=(n_max, 3))
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    sets["bounce"] = (bo, v3(bd), rec.prim)
    return sets


def check_k1(torch, np, scene, cfg):
    """Phase 2: K1 against its twin, and its times.  Returns the kernel's
    record for the JSON line (launches filled in later)."""
    from simple_spectral_torch.render import intersect_pallas as k1
    from simple_spectral_torch.render.vec import V3

    n_max = WIDTH * HEIGHT
    sets = ray_sets(torch, np, scene, cfg, n_max)
    tv, tp = scene.tri_verts, scene.tri_prim
    max_err = 0
    for name, (o, d, ign) in sets.items():
        for n in (1, 7, 2049, n_max):
            for use_ignore in (False, True):
                oo, dd = V3(*(c[:n] for c in o)), V3(*(c[:n] for c in d))
                ig = ign[:n] if use_ignore else torch.full((n,), -1, dtype=torch.int32, device=ign.device)
                got = k1.intersect_best_key(tv, tp, oo, dd, ig, cfg.eps)
                want = k1.best_key_plain(tv, tp, oo, dd, ig, cfg.eps)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
                hits = int((got < k1.INF_BITS).sum())
                print(f"K1 vs twin: {name:7s} N={n:6d} ignore={'on ' if use_ignore else 'off'} "
                      f"hits={hits:6d} max|key diff|={err}")
                if err != 0:
                    fail(f"K1 disagrees with its twin on {name} rays, N={n}, ignore={use_ignore}")
                max_err = max(max_err, err)

    # times at the main path's sweep size, on bounce rays (16 of 18 sweeps)
    o, d, ign = sets["bounce"]
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
    tris = tv.reshape(-1, 9).contiguous()
    ms = time_ms(lambda: k1.best_key_cuda(rays, ign, tris, tp, cfg.eps), 30, torch)
    plain_ms = time_ms(lambda: k1.best_key_plain(tv, tp, o, d, ign, cfg.eps), 5, torch)
    t = scene.n_tris
    bytes_moved = n_max * (6 * 4 + 4 + 4) + t * (9 * 4 + 4)
    ops = n_max * t * K1_OPS_PER_TEST
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"K1 at N={n_max}, T={t}: kernel {ms:.4f} ms (median of 30), twin {plain_ms:.4f} ms (median of 5), "
          f"bound {bound_ms:.4f} ms ({ops / 1e9:.3f} GFLOP -> {ops_ms:.4f} ms; "
          f"{bytes_moved / 1e6:.2f} MB -> {bytes_ms:.4f} ms)")
    return {
        "name": "intersect_best_key",
        "route": "cuda",
        "source": "simple_spectral_torch/csrc/intersect_best_key.cu",
        "replaces": "simple_spectral_tpu/render/intersect_pallas.py:74",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port is the checkout's own copy beside this script, never an
    # installed one
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "simple_spectral_torch", "csrc", "intersect_best_key.cu")):
        print(f"chip_smoke: no simple_spectral_torch package with its sources beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from simple_spectral_torch.render import intersect_pallas as k1
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.render.renderer import render_accumulate, render_chunk_lanes, render_image
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # --- phase 1: build K1 from the checkout's sources ---
    t0 = time.time()
    lib = k1.build()
    print(f"K1 built in {time.time() - t0:.2f} s -> {os.path.relpath(lib)}")

    # --- phase 2: K1 against its twin ---
    cfg = RenderConfig(scene="cornell-srgb", width=WIDTH, height=HEIGHT, spp=SPP, mode="mallett",
                       observer=1931, n_wavelengths=4, max_depth=10, els=True)
    dev = torch.device("cuda")
    t0 = time.time()
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    print(f"tables + scene built in {time.time() - t0:.2f} s ({scene.n_tris} triangles)")
    record = check_k1(torch, np, scene, cfg)

    # --- phase 3: the slice at full width ---
    render_image(cfg.replace(width=64, height=64, spp=1), scene, tables, device=dev)  # warm-up
    torch.cuda.synchronize()
    chunks = -(-(cfg.width * cfg.height) // render_chunk_lanes(cfg, scene))
    k1.LAUNCHES = 0
    t0 = time.time()
    fb = render_image(cfg, scene, tables, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = k1.LAUNCHES
    expect = (2 * cfg.max_depth - 2) * cfg.spp * chunks
    print(f"render_image {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp {cfg.mode} depth {cfg.max_depth}: "
          f"{dt:.3f} s, K1 launches {launches} (expected {expect})")
    if launches != expect:
        fail(f"K1 launched {launches} times on the main path, expected {expect}")
    record["launches"] = launches
    if fb.shape != (cfg.height, cfg.width, 4) or not np.isfinite(fb).all():
        fail(f"framebuffer not finite or of shape {fb.shape}")
    alpha = fb[..., 3]
    quarter = (slice(cfg.height // 4, 3 * cfg.height // 4), slice(cfg.width // 4, 3 * cfg.width // 4))
    on_grid = np.abs(alpha * cfg.spp - np.round(alpha * cfg.spp)).max()
    print(f"alpha: mean {alpha.mean():.6f}, central half min {alpha[quarter].min():.3f}, "
          f"off the 1/spp grid by {on_grid:.2e}")
    if not (0.9 < alpha.mean() < 1.0) or alpha[quarter].min() != 1.0 or on_grid > 1e-6:
        fail("alpha coverage is not that of the cornell box seen through the camera")
    png = os.path.join(k1.BUILD_DIR, "chip_smoke_cornell_srgb.png")
    save_image(png, fb)
    mrays = cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth - 1) / dt / 1e6
    print(f"forward: {mrays:.3f} Mrays/s (19 rays per sample) on {kind} [{card}]; image -> {os.path.relpath(png)}")

    # --- phase 4: kernel path against the plain path, end to end ---
    small = cfg.replace(width=16, height=16, spp=2)
    cpu = torch.device("cpu")
    t_cpu = build_color_tables(small, device=cpu)
    v_gpu, a_gpu = render_accumulate(small, build_scene(small, tables, device=dev), tables, seed=3)
    v_cpu, a_cpu = render_accumulate(small, build_scene(small, t_cpu, device=cpu), t_cpu, seed=3)
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    n_px = small.width * small.height
    mean_rel = np.abs(v_gpu.mean(axis=(0, 1)) / v_cpu.mean(axis=(0, 1)) - 1.0).max()
    print(f"cuda vs cpu {small.width}x{small.height}@{small.spp}spp: {flipped}/{n_px} pixels differ by rel >= 1e-3, "
          f"worst rel {rel.max():.3e}, means rel {mean_rel:.3e}, alpha equal {np.array_equal(a_gpu, a_cpu)}")
    if flipped > n_px // 16 or rel.max() >= 0.5 or mean_rel > 2e-3:
        fail("the card's render and the CPU render disagree beyond the flip bound")

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
