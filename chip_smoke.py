#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  In order, it

1. prints the card's name and power limit and builds the four kernels from
   source, one nvcc each, started together: K1
   (simple_spectral_torch/csrc/intersect_best_key.cu), K2 (csrc/cull_best.cu),
   S1 (csrc/bounce_fused.cu) and gather_u32 (csrc/gather_u32.cu);
2. holds K1 key for key against its plain PyTorch twin on the card, in both
   key widths (the quantized 32-bit key of the "pallas" route and the exact
   64-bit key of "xla" and "auto"), on seeded random rays inside the
   cornell-srgb bounds and on real camera and bounce rays, at N in {1, 7,
   2049, 262144, 262145, 600000} (the last two more than one grid sized to
   residency takes in one pass), with the ignored primitive on and off, and
   over the 10,038 triangles of cornell-stress's dense route at 1000 boxes
   (79 tiles, the last partial); times both widths, the call as the render
   makes it (``intersect_best_key``) and one ray (the fixed cost of a
   launch), all the card alone, and the twin (host-inclusive) at N = 262144,
   beside the kernel's bound and its issue floor (its SASS instructions per
   test, ``tools.kernel_report``);
3. runs this slice's main path, bench.py's call: ``forward_backward_step`` on
   cornell-srgb at 512x512 (262144 lanes, mallett, CIE 1931, 4 hero
   wavelengths, depth 10, explicit light sampling, u32 texels, spp 1, target
   zero), checks that K1 launched 18 times in the call and K2 not, a finite
   loss, finite gradients and a non-zero gradient of emission_values, and
   prints the forward+backward Mrays/s as simple_spectral_torch/bench.py
   measures it (19 rays per sample, CUDA events; median and spread over 3
   rounds of 3 calls), the forward-only Mrays/s of the same call (one round)
   and the peak device memory;
4. runs the same step at 8x8, 2 spp, depth 3 on the card and on the CPU and
   holds loss and scaled gradients within TRAIN_LOSS_RTOL and
   TRAIN_GRAD_ATOL;
5. renders cornell-srgb at 512x512 (the same configuration, 4 spp) through
   ``render_image`` on the card, checks K1's launch count (18 sweeps per
   sample and chunk) and that K2 did not launch, a finite framebuffer and
   the alpha coverage, writes the PNG under simple_spectral_torch/_build/
   and prints the forward Mrays/s;
6. renders a 16x16, 2 spp frame from the same key on the card (through K1)
   and on the CPU (through the twin) and holds the two within the flip bound
   of tests/test_parallel.py;
7. builds the scale path's scene, cornell-stress with 5000 boxes and 250
   spheres (50,288 primitives, 1205 clusters), timing the host build, and
   holds K2 key for key and slot for slot against its twin on random,
   camera and bounce rays, at N in {1, 1023, 1025, 262144}, in the rays'
   order and in Morton order, with the ignored primitive on and off; times
   both at N = 262144 on sorted bounce rays beside the bound counted by
   ``cull.cull_work`` from the work these inputs need (each lane walking to
   its own exit), and prints the kernel's own work (``visits``) against it,
   holding that work equal to the twin's walk with the kernel's warp vote;
8. renders that scene at 512x512 (rgb, depth 10, ELS, 1 spp, intersect_impl
   "auto") through ``render_image``, checks that K2 launched 18 times per
   sample and chunk and K1 none, a finite framebuffer and the alpha
   coverage, and prints the forward Mrays/s and the peak device memory;
9. renders a 16x16, 2 spp stress frame with two sphere lights through K2
   on the card and through the twin on the CPU, within the same flip bound;
10. drives the fused-bounce entry point's path (one S1 launch on 262144
   camera rays of cornell), checks that lanes hit, holds S1 against its
   twin (distance and primitive ids bit for bit, wi and n.wi within 1e-6),
   there and at 262145 lanes, and times both, and S1 at one lane, beside
   the bound and the issue floor;
11. drives the gather entry point's path (one gather_u32 launch over the
   real merged texel-fetch indices of a cornell-srgb sample at 512x512,
   depth 10), then holds gather_u32 word for word against its twin and
   ``torch.take`` / ``torch.gather`` on those indices and on the spikes'
   shapes, timing all three beside the byte bound;
12. prints one JSON line describing every kernel, then the result line.

Kernel and library times are the card's alone (``tools.cuda_time_ms``: many
launches back to back between one pair of CUDA events, behind a device
spin that covers the host's enqueue; the L2 stays warm between launches, as
on the render path, where stage 2 reads every tile's row 0 just before K2
runs).  The twins wait for the device inside (they read counts back), so
their times are host-inclusive (``tools.host_inclusive_ms``, one call
between a pair of events).

Any failure exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

SPP = 4
WIDTH = HEIGHT = 512
# the main path: bench.py's forward_backward_step call
TRAIN = dict(scene="cornell-srgb", mode="mallett", observer=1931, n_wavelengths=4, max_depth=10, els=True,
             texel_format="u32")
TRAIN_ROUNDS, TRAIN_CALLS = 3, 3
# the step on the card against the step on the CPU, both the port's: on an
# H100 80GB HBM3 at 700 W the loss differed by 4.2e-5 relative and the
# gradients, scaled by their max, by 1.38e-4 (phase 4 of this script)
TRAIN_LOSS_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-3
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")
# the scale path's configuration: tools/bench_stress_render.py at 5000 boxes
STRESS = dict(scene="cornell-stress", mode="rgb", stress_boxes=5000, stress_spheres=250, stress_materials=16,
              max_depth=10, els=True, intersect_impl="auto")
STRESS_SPP = 1
# K1's largest set: more rays than one grid sized to residency takes in one
# pass on an H100 (1056 CTAs x 256 rays)
K1_N_OVER = 600000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def issue_floor(lib, match, tests):
    """(SASS instructions per test on the reject path, registers, CTAs per
    SM, issue floor ms of ``tests`` (ray, triangle) tests) of a built
    kernel (``tools.kernel_report``)."""
    from simple_spectral_torch.tools import kernel_report

    rec = max(kernel_report.report(lib, match, tests), key=lambda r: r.get("per_test", 0))
    return rec["per_test"], rec["regs"], rec["ctas_per_sm"], rec["issue_floor_ms"]


def check_k1(torch, np, scene, cfg):
    """Phase 2: K1 against its twin in both key widths, and its times.
    Returns the kernel's record for the JSON line (launches filled in
    later); its time is the exact width's, which the main path runs."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.render import intersect_pallas as k1
    from simple_spectral_torch.render.vec import V3
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables
    from simple_spectral_torch.tools import OPS_PER_TRIANGLE_TEST, bound_ms, cuda_time_ms, host_inclusive_ms

    n_max = WIDTH * HEIGHT
    # up to more rays than one grid sized to residency takes in one pass
    sets = ray_sets(torch, np, scene, cfg, K1_N_OVER)
    tv, tp = scene.tri_verts, scene.tri_prim
    max_err = 0

    def hold(width, name, tv, tp, o, d, ig, n_tris, exact):
        got = k1.intersect_best_key(tv, tp, o, d, ig, cfg.eps, exact)
        want = k1.best_key_plain(tv, tp, o, d, ig, cfg.eps, exact)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        hits = int(k1.key_parts(got, n_tris, exact)[0].sum())
        print(f"K1 vs twin, {width} key: {name:7s} T={n_tris:5d} N={o.x.shape[0]:6d} hits={hits:6d} "
              f"max|key diff|={err}")
        if err != 0 or got.dtype != want.dtype:
            fail(f"K1 disagrees with its twin ({width} key) on {name} rays, T={n_tris}, N={o.x.shape[0]}")
        return err

    for exact in (False, True):
        width = "exact 64-bit" if exact else "quantized 32-bit"
        for name, (o, d, ign) in sets.items():
            for n in (1, 7, 2049, n_max, n_max + 1, K1_N_OVER):
                for use_ignore in (False, True):
                    oo, dd = V3(*(c[:n] for c in o)), V3(*(c[:n] for c in d))
                    ig = ign[:n] if use_ignore else torch.full((n,), -1, dtype=torch.int32, device=ign.device)
                    label = f"{name}, ignore {'on' if use_ignore else 'off'}"
                    max_err = max(max_err, hold(width, label, tv, tp, oo, dd, ig, scene.n_tris, exact))
    # more triangles than one tile, the last tile partial: the dense route of
    # cornell-stress at 1000 boxes (below the cull threshold)
    d_cfg = RenderConfig(scene="cornell-stress", mode="rgb", width=8, height=8, stress_boxes=1000,
                         bvh_threshold=1 << 30)
    dense = build_scene(d_cfg, build_color_tables(d_cfg, device=scene.device), device=scene.device)
    dense_sets = ray_sets(torch, np, dense, d_cfg, 2049)
    for exact in (False, True):
        for name, (o, d, ign) in dense_sets.items():
            max_err = max(max_err, hold("exact 64-bit" if exact else "quantized 32-bit", f"{name}, dense",
                                        dense.tri_verts, dense.tri_prim, o, d, ign, dense.n_tris, exact))

    # times at the main path's sweep size, on bounce rays (16 of 18 sweeps)
    bo, bd, bign = sets["bounce"]
    o, d = V3(*(c[:n_max].contiguous() for c in bo)), V3(*(c[:n_max].contiguous() for c in bd))
    ign = bign[:n_max].contiguous()
    tris = tv.reshape(-1, 9).contiguous()
    ms_q = cuda_time_ms(lambda: k1.best_key_cuda(o, d, ign, tris, tp, cfg.eps))
    ms = cuda_time_ms(lambda: k1.best_key_cuda(o, d, ign, tris, tp, cfg.eps, exact=True))
    called_ms = cuda_time_ms(lambda: k1.intersect_best_key(tv, tp, o, d, ign, cfg.eps, exact=True))
    o1, d1 = (V3(*(c[:1] for c in v)) for v in (o, d))
    one_ms = cuda_time_ms(lambda: k1.best_key_cuda(o1, d1, ign[:1], tris, tp, cfg.eps, exact=True))
    plain_ms = host_inclusive_ms(lambda: k1.best_key_plain(tv, tp, o, d, ign, cfg.eps, exact=True), 5)
    t = scene.n_tris
    bytes_moved = n_max * (6 * 4 + 4 + 8) + t * (9 * 4 + 4)  # rays, ignore id, 64-bit key; triangles
    bound, bound_by, ops_ms, bytes_ms = bound_ms(n_max * t * OPS_PER_TRIANGLE_TEST, bytes_moved)
    per_test, regs, ctas, floor_ms = issue_floor(kernels.library_path(k1.SOURCE), "best_key_kernel", n_max * t)
    print(f"K1 at N={n_max}, T={t}: exact key {ms:.4f} ms, quantized key {ms_q:.4f} ms, as called "
          f"(intersect_best_key, exact) {called_ms:.4f} ms, at N=1 (the fixed cost) {one_ms:.4f} ms (card alone, "
          f"100 launches each); twin (exact) {plain_ms:.4f} ms (host-inclusive, median of 5); bound {bound:.4f} ms "
          f"({ops_ms:.4f} ms of operations, {bytes_ms:.4f} ms of bytes); issue floor {floor_ms:.4f} ms "
          f"({per_test:.2f} SASS instructions per test, {regs} registers, {ctas} CTAs per SM)")
    return {
        "name": "intersect_best_key",
        "route": "cuda",
        "source": "simple_spectral_torch/csrc/intersect_best_key.cu",
        "replaces": "simple_spectral_tpu/render/intersect_pallas.py:74",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }


def k2_inputs(torch, k2, scene, o, d, ign, n, sort, eps):
    """Stage-2 inputs of K2 for the first n rays, optionally in Morton order."""
    from simple_spectral_torch.render.vec import V3

    o, d, ign = V3(*(c[:n] for c in o)), V3(*(c[:n] for c in d)), ign[:n]
    if sort:
        order = k2.morton_order(scene.cull_tiles, o, d)
        o, d, ign = V3(*(c[order] for c in o)), V3(*(c[order] for c in d)), ign[order]
    rays = k2.cull_rays(o, d, ign)
    counts, lists, entries = k2.cull_lists(scene.cull_tiles, rays, eps)
    return counts, lists, entries, rays


def k2_bound(torch, k2, tiles, counts, lists, entries, rays, n, eps, visits):
    """K2's least time on these inputs, from ``cull.cull_work``: the work
    of every lane walking its block's list to its own exit, whatever kernel
    does it.  Also holds the kernel's own work (``visits``: (warp, cluster)
    pairs, triangle and sphere tests) equal to the twin's walk with the
    kernel's warp vote.  Returns (bound_ms, bound_by, text)."""
    from simple_spectral_torch.tools import OPS_PER_TRIANGLE_TEST, bound_ms

    need = k2.cull_work(tiles, counts, lists, entries, rays, eps, n_valid=n)
    warp = k2.cull_work(tiles, counts, lists, entries, rays, eps, n_valid=n, group=k2.WARP)
    pairs, tri, sph = (int(v.to(torch.int64).sum()) for v in visits)
    own = (pairs * k2.WARP, tri, sph)
    if own != tuple(int(warp[k].sum()) for k in ("slab", "tri", "sphere")):
        fail(f"K2's own work (slab, triangle, sphere tests) {own} is not that of the twin's walk with its warp "
             f"vote {tuple(int(warp[k].sum()) for k in ('slab', 'tri', 'sphere'))}")
    own_ops = own[0] * k2.SLAB_OPS + tri * OPS_PER_TRIANGLE_TEST + sph * k2.SPHERE_OPS
    bound, bound_by, ops_ms, bytes_ms = bound_ms(need["ops"], need["bytes"])
    text = (f"the inputs need {int(need['slab'].sum())} slab, {int(need['tri'].sum())} triangle and "
            f"{int(need['sphere'].sum())} sphere tests, {need['ops'] / 1e9:.3f} GFLOP -> {ops_ms:.4f} ms, "
            f"{need['bytes'] / 1e6:.2f} MB -> {bytes_ms:.4f} ms ({need['clusters']} clusters, "
            f"{need['positions']} list positions); the kernel did {pairs} (warp, cluster) pairs = {own[0]} slab, "
            f"{tri} triangle and {sph} sphere tests, {own_ops / 1e9:.3f} GFLOP "
            f"({own_ops / need['ops']:.3f}x the inputs' work), rows in {warp['row_pairs']} of those pairs "
            f"({tri / max(warp['row_pairs'], 1):.2f} triangle tests per pair); {int(counts.sum())} (block, cluster) "
            f"pairs listed")
    return bound, bound_by, text


def check_k2(torch, np, scene, cfg):
    """Phase 5: K2 against its twin, and its times.  Returns the kernel's
    record for the JSON line (launches filled in later)."""
    from simple_spectral_torch.render import cull as k2
    from simple_spectral_torch.tools import cuda_time_ms, host_inclusive_ms

    n_max = WIDTH * HEIGHT
    sets = ray_sets(torch, np, scene, cfg, n_max)
    max_err = 0
    for name, (o, d, ign) in sets.items():
        for n in (1, 1023, 1025, n_max):
            for sort in (False, True):
                for use_ignore in (False, True):
                    ig = ign if use_ignore else torch.full_like(ign, -1)
                    counts, lists, entries, rays = k2_inputs(torch, k2, scene, o, d, ig, n, sort, cfg.eps)
                    got = k2.cull_best(scene.cull_tiles, counts, lists, entries, rays, n, cfg.eps)
                    want = k2.cull_best_plain(scene.cull_tiles, counts, lists, rays, cfg.eps)
                    torch.cuda.synchronize()
                    err = int((got[:, :n].to(torch.int64) - want[:, :n].to(torch.int64)).abs().max())
                    hits = int((got[0, :n] < k2.INF_BITS).sum())
                    print(f"K2 vs twin: {name:7s} N={n:6d} {'sorted  ' if sort else 'unsorted'} "
                          f"ignore={'on ' if use_ignore else 'off'} hits={hits:6d} "
                          f"clusters listed per block {float(counts.float().mean()):7.1f} max|diff|={err}",
                          flush=True)
                    if err != 0:
                        fail(f"K2 disagrees with its twin on {name} rays, N={n}, sorted={sort}, ignore={use_ignore}")
                    max_err = max(max_err, err)

    # times at the main path's sweep size, on sorted bounce rays
    o, d, ign = sets["bounce"]
    counts, lists, entries, rays = k2_inputs(torch, k2, scene, o, d, ign, n_max, True, cfg.eps)
    tiles = scene.cull_tiles
    visits = torch.zeros((3, counts.shape[0]), dtype=torch.int32, device=counts.device)
    k2.cull_best_cuda(tiles, counts, lists, entries, rays, n_max, cfg.eps, visits=visits)
    ms = cuda_time_ms(lambda: k2.cull_best_cuda(tiles, counts, lists, entries, rays, n_max, cfg.eps))
    plain_ms = host_inclusive_ms(lambda: k2.cull_best_plain(tiles, counts, lists, rays, cfg.eps), 3)
    bound_ms, bound_by, text = k2_bound(torch, k2, tiles, counts, lists, entries, rays, n_max, cfg.eps, visits)
    print(f"K2 at N={n_max}, C={tiles.shape[0]}, sorted bounce rays: kernel {ms:.4f} ms (card alone, 100 "
          f"launches), twin {plain_ms:.4f} ms (host-inclusive, median of 3), bound {bound_ms:.4f} ms "
          f"({bound_by}; {text})")
    # the plain torch around K2 in one sweep: the Morton order and stage 2
    sort_ms = host_inclusive_ms(lambda: k2.morton_order(tiles, o, d), 10)
    stage2_ms = host_inclusive_ms(lambda: k2.cull_lists(tiles, rays, cfg.eps), 10)
    print(f"around K2 in one sweep at N={n_max}: morton_order {sort_ms:.4f} ms, cull_lists (stage 2) "
          f"{stage2_ms:.4f} ms (host-inclusive, medians of 10)")
    return {
        "name": "cull_best",
        "route": "cuda",
        "source": "simple_spectral_torch/csrc/cull_best.cu",
        "replaces": "simple_spectral_tpu/render/cull.py:165",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def check_alpha(np, fb, spp, what):
    alpha = fb[..., 3]
    h, w = alpha.shape
    quarter = (slice(h // 4, 3 * h // 4), slice(w // 4, 3 * w // 4))
    on_grid = np.abs(alpha * spp - np.round(alpha * spp)).max()
    print(f"alpha: mean {alpha.mean():.6f}, central half min {alpha[quarter].min():.3f}, "
          f"off the 1/spp grid by {on_grid:.2e}")
    if not (0.9 < alpha.mean() < 1.0) or alpha[quarter].min() != 1.0 or on_grid > 1e-6:
        fail(f"alpha coverage is not that of the cornell box seen through the camera ({what})")


def cuda_vs_cpu(np, cfg, tables, dev, torch):
    """The same small frame on the card and on the CPU, within the flip bound."""
    from simple_spectral_torch.render.renderer import render_accumulate
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cpu = torch.device("cpu")
    t_cpu = build_color_tables(cfg, device=cpu)
    v_gpu, a_gpu = render_accumulate(cfg, build_scene(cfg, tables, device=dev), tables, seed=3)
    v_cpu, a_cpu = render_accumulate(cfg, build_scene(cfg, t_cpu, device=cpu), t_cpu, seed=3)
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    n_px = cfg.width * cfg.height
    mean_rel = np.abs(v_gpu.mean(axis=(0, 1)) / v_cpu.mean(axis=(0, 1)) - 1.0).max()
    print(f"cuda vs cpu {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp: {flipped}/{n_px} pixels differ by "
          f"rel >= 1e-3, worst rel {rel.max():.3e}, means rel {mean_rel:.3e}, "
          f"alpha equal {np.array_equal(a_gpu, a_cpu)}")
    if flipped > n_px // 16 or rel.max() >= 0.5 or mean_rel > 2e-3 or not np.array_equal(a_gpu, a_cpu):
        fail(f"the card's {cfg.scene} render and the CPU render disagree beyond the flip bound")


def train_step_phase(torch, np, scene, tables, cfg, k1, k2):
    """Phase 3: bench.py's forward_backward_step call on the card.  Returns
    K1's launches in one call."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.bench import bench_config
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step

    dev = scene.device
    n = cfg.width * cfg.height
    px = torch.arange(n, dtype=torch.int32, device=dev)
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    key = rnd.PRNGKey(0)
    forward_backward_step(scene, tables, cfg, rnd.fold_in(key, 99), px, target, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = k2.LAUNCHES = 0
    loss, grads = forward_backward_step(scene, tables, cfg, rnd.fold_in(key, 0), px, target, 1)
    torch.cuda.synchronize()
    launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = 2 * cfg.max_depth - 2
    g_max = {f: float(g.abs().max()) for f, g in grads.items()}
    print(f"forward_backward_step {cfg.scene} {n} lanes x 1 spp {cfg.mode} depth {cfg.max_depth}: loss "
          f"{float(loss):.6g}, K1 launches {launches} (expected {expect}), K2 launches {k2_launches}, "
          f"max |grad| {g_max}, peak device memory {peak_gb:.3f} GB")
    if launches != expect or k2_launches != 0:
        fail(f"the train step launched K1 {launches} times (expected {expect}) and K2 {k2_launches} (expected 0)")
    if not torch.isfinite(loss) or not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        fail("the train step's loss or a gradient is not finite")
    if g_max["emission_values"] == 0.0:
        fail("emission_values has a zero gradient")

    mrays = [bench_config(cfg, tables, scene, rnd.fold_in(key, 1 + r), 1, TRAIN_CALLS, n)
             for r in range(TRAIN_ROUNDS)]
    fwd = bench_config(cfg, tables, scene, rnd.fold_in(key, 1 + TRAIN_ROUNDS), 1, TRAIN_CALLS, n,
                       step_fn=forward_only_step)
    rays = n * (2 * cfg.max_depth - 1)
    mid = statistics.median(mrays)
    print(f"forward+backward: {mid:.3f} Mrays/s (median of {TRAIN_ROUNDS} rounds of {TRAIN_CALLS} calls, spread "
          f"{min(mrays):.3f}-{max(mrays):.3f}; {rays / mid / 1e3:.3f} ms per call); forward only {fwd:.3f} Mrays/s "
          f"({rays / fwd / 1e3:.3f} ms per call, one round of {TRAIN_CALLS}); peak device memory {peak_gb:.3f} GB")
    return launches


def train_cuda_vs_cpu(torch, np, cfg):
    """Phase 4: the same small train step on the card and on the CPU."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.render.trainstep import forward_backward_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    n = cfg.width * cfg.height
    target = np.random.default_rng(3).uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        tables = build_color_tables(cfg, device=dev)
        scene = build_scene(cfg, tables, device=dev)
        px = torch.arange(n, dtype=torch.int32, device=dev)
        loss, grads = forward_backward_step(scene, tables, cfg, rnd.PRNGKey(3), px, torch.from_numpy(target).to(dev),
                                            cfg.spp)
        out[dev.type] = (float(loss), {f: g.cpu().numpy() for f, g in grads.items()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(l_gpu / l_cpu - 1.0)
    grad_err = {f: float(np.abs(g_gpu[f] - g_cpu[f]).max() / max(np.abs(g_cpu[f]).max(), 1e-8)) for f in g_cpu}
    print(f"train step cuda vs cpu {cfg.width}x{cfg.height}@{cfg.spp}spp depth {cfg.max_depth}: loss rel "
          f"{loss_rel:.3e}, scaled grad errors {grad_err}")
    if loss_rel > TRAIN_LOSS_RTOL or max(grad_err.values()) > TRAIN_GRAD_ATOL:
        fail(f"the card's train step and the CPU's disagree beyond loss rtol {TRAIN_LOSS_RTOL} or scaled "
             f"gradient atol {TRAIN_GRAD_ATOL}")


def bounce_phase(torch, s1):
    """Phase 10: the fused-bounce entry point's path, S1 against its twin,
    at N = 262144 and at one lane more than one grid sized to residency
    takes in one pass; its times at N = 262144 and at N = 1."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.tools import cuda_time_ms

    s1.LAUNCHES = 0
    rows, light, rays, u, out = s1.run("cuda")
    torch.cuda.synchronize()
    launches = s1.LAUNCHES
    rec = s1.measure(rows, light, rays, u, out)
    n = rays.shape[1]
    one_ms = cuda_time_ms(lambda: s1.bounce_cuda(rows, light, rays[:, :1].contiguous(), u[:, :1].contiguous()))
    per_test, regs, ctas, floor_ms = issue_floor(kernels.library_path(s1.SOURCE), "bounce_kernel", 2 * n * s1.SEL)
    print(f"S1 fused bounce at N={n}: launches {launches}, {rec['hits']} lanes hit, "
          f"{rec['shadow_prims']} distinct shadow prims; vs twin: {rec['dist_prim_bits_differ']} lanes with "
          f"dist/prim bits apart, wi/n.wi max |diff| {rec['max_abs_err']:.3e}; kernel {rec['ms']:.4f} ms, at N=1 "
          f"(the fixed cost) {one_ms:.4f} ms (card alone, 100 launches each), eager twin {rec['plain_ms']:.4f} ms "
          f"(host-inclusive, median of 5), bound {rec['bound_ms']:.4f} ms ({rec['bound_text']}); issue floor of the "
          f"sweeps {floor_ms:.4f} ms ({per_test:.2f} SASS instructions per test, {regs} registers, {ctas} CTAs per SM)")
    if launches != 1 or rec["hits"] == 0:
        fail(f"the fused bounce launched S1 {launches} times (expected 1) with {rec['hits']} hits")
    if rec["dist_prim_bits_differ"] or rec["max_abs_err"] > s1.WI_TOL:
        fail("S1 disagrees with its twin")
    o_rows, o_light, o_rays, o_u, o_out = s1.run("cuda", n + 1, seed=1)
    diff = s1.compare(o_out, s1.bounce_plain(o_rows, o_light, o_rays, o_u))
    print(f"S1 at N={n + 1}: {diff['dist_prim_bits_differ']} lanes with dist/prim bits apart, wi/n.wi max |diff| "
          f"{diff['wi_ndl_max_abs_err']:.3e}")
    if diff["dist_prim_bits_differ"] or diff["wi_ndl_max_abs_err"] > s1.WI_TOL:
        fail(f"S1 disagrees with its twin at N={n + 1}")
    rec["launches"] = launches
    return {k: rec[k] for k in KERNEL_KEYS}


def gather_phase(torch, tg):
    """Phase 11: the gather entry point's path, gather_u32 against its twin
    and the library call on every variant."""
    tg.LAUNCHES = 0
    table, idx, out = tg.run("cuda")
    torch.cuda.synchronize()
    launches = tg.LAUNCHES
    if launches != 1 or not torch.equal(out, tg.gather_u32_plain(table, idx, idx.numel(), 1, 0, table.numel() - 1)):
        fail(f"the texel gather launched gather_u32 {launches} times (expected 1) or disagrees with its twin")
    main_rec = None
    for label, tab, ind, rows, cols, axis, mask in tg.variants(table, idx):
        rec = tg.measure(tab, ind, rows, cols, axis, mask)
        print(f"gather_u32 {label:38s} {rows * cols:8d} idx: kernel {rec['ms']:.4f} ms, torch "
              f"{rec['library_ms']:.4f} ms (card alone, 100 launches each), twin {rec['plain_ms']:.4f} ms "
              f"(host-inclusive, median of 30), bound {rec['bound_ms']:.4f} ms; words apart from the twin "
              f"{rec['words_differ']}, from torch {rec['library_differs']}")
        if rec["words_differ"] or rec["library_differs"]:
            fail(f"gather_u32 disagrees with its twin or torch on {label}")
        main_rec = main_rec or rec
    return {"name": "gather_u32", "route": "cuda", "source": "simple_spectral_torch/csrc/gather_u32.cu",
            "replaces": "tools/bench_pallas_gather.py:81", "launches": launches, "max_abs_err": main_rec["max_abs_err"],
            "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "library_ms": main_rec["library_ms"]}


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
    csrc = os.path.join(root, "simple_spectral_torch", "csrc")
    sources = ("intersect_best_key.cu", "cull_best.cu", "bounce_fused.cu", "gather_u32.cu")
    if not all(os.path.isfile(os.path.join(csrc, f)) for f in sources):
        print(f"chip_smoke: no simple_spectral_torch package with its sources beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from simple_spectral_torch import kernels
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.render import cull as k2
    from simple_spectral_torch.render import intersect_pallas as k1
    from simple_spectral_torch.render.renderer import render_chunk_lanes, render_image
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables
    from simple_spectral_torch.tools import bench_gather as tg
    from simple_spectral_torch.tools import bench_megakernel as s1
    from simple_spectral_torch.tools import card_line

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # --- phase 1: build the four kernels from the checkout's sources ---
    t0 = time.time()
    libs = kernels.build(k1.SOURCE, k2.SOURCE, s1.SOURCE, tg.SOURCE)
    print(f"K1, K2, S1 and gather_u32 built in {time.time() - t0:.2f} s -> "
          f"{', '.join(os.path.relpath(p) for p in libs)}", flush=True)

    # --- phase 2: K1 against its twin, both key widths ---
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, **TRAIN)
    dev = torch.device("cuda")
    t0 = time.time()
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    print(f"tables + scene built in {time.time() - t0:.2f} s ({scene.n_tris} triangles)")
    record = check_k1(torch, np, scene, cfg)

    # --- phase 3: this slice's main path, bench.py's train step ---
    record["launches"] = train_step_phase(torch, np, scene, tables, cfg, k1, k2)

    # --- phase 4: the train step on the card against the CPU ---
    train_cuda_vs_cpu(torch, np, cfg.replace(width=8, height=8, spp=2, max_depth=3))

    # --- phase 5: the first slice's path, the forward render at full width ---
    render_image(cfg.replace(width=64, height=64, spp=1), scene, tables, device=dev)  # warm-up
    torch.cuda.synchronize()
    chunks = -(-(cfg.width * cfg.height) // render_chunk_lanes(cfg, scene))
    k1.LAUNCHES = k2.LAUNCHES = 0
    t0 = time.time()
    fb = render_image(cfg, scene, tables, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
    expect = (2 * cfg.max_depth - 2) * cfg.spp * chunks
    print(f"render_image {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp {cfg.mode} depth {cfg.max_depth}: "
          f"{dt:.3f} s, K1 launches {launches} (expected {expect}), K2 launches {k2_launches}")
    if launches != expect or k2_launches != 0:
        fail(f"K1 launched {launches} times (expected {expect}) and K2 {k2_launches} (expected 0)")
    if fb.shape != (cfg.height, cfg.width, 4) or not np.isfinite(fb).all():
        fail(f"framebuffer not finite or of shape {fb.shape}")
    check_alpha(np, fb, cfg.spp, cfg.scene)
    png = os.path.join(kernels.BUILD_DIR, "chip_smoke_cornell_srgb.png")
    save_image(png, fb)
    mrays = cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth - 1) / dt / 1e6
    print(f"forward: {mrays:.3f} Mrays/s (19 rays per sample) on {kind} [{card}]; image -> {os.path.relpath(png)}")

    # --- phase 6: K1 path against the plain path, end to end ---
    cuda_vs_cpu(np, cfg.replace(width=16, height=16, spp=2), tables, dev, torch)

    # --- phase 7: the scale path's scene; K2 against its twin ---
    s_cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=STRESS_SPP, **STRESS)
    s_tables = build_color_tables(s_cfg, device=dev)
    t0 = time.time()
    s_scene = build_scene(s_cfg, s_tables, device=dev)
    host_build_s = time.time() - t0
    print(f"cornell-stress built in {host_build_s:.2f} s on the host: {s_scene.n_tris} triangles, "
          f"{s_scene.n_spheres} spheres, {s_scene.cull_tiles.shape[0]} clusters, "
          f"{s_scene.n_bvh_entries} BVH entries, {s_scene.materials.n_materials} materials", flush=True)
    k2_record = check_k2(torch, np, s_scene, s_cfg)

    # --- phase 8: the scale path at full width ---
    render_image(s_cfg.replace(width=64, height=64), s_scene, s_tables, device=dev)  # warm-up
    torch.cuda.synchronize()
    chunks = -(-(s_cfg.width * s_cfg.height) // render_chunk_lanes(s_cfg, s_scene))
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = k2.LAUNCHES = 0
    t0 = time.time()
    fb = render_image(s_cfg, s_scene, s_tables, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    k1_launches, launches = k1.LAUNCHES, k2.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = (2 * s_cfg.max_depth - 2) * s_cfg.spp * chunks
    print(f"render_image {s_cfg.scene} {s_cfg.width}x{s_cfg.height}@{s_cfg.spp}spp {s_cfg.mode} "
          f"depth {s_cfg.max_depth}: {dt:.3f} s, K2 launches {launches} (expected {expect}), "
          f"K1 launches {k1_launches}, peak device memory {peak_gb:.3f} GB")
    if launches != expect or k1_launches != 0:
        fail(f"K2 launched {launches} times (expected {expect}) and K1 {k1_launches} (expected 0)")
    k2_record["launches"] = launches
    if fb.shape != (s_cfg.height, s_cfg.width, 4) or not np.isfinite(fb).all():
        fail(f"framebuffer not finite or of shape {fb.shape}")
    check_alpha(np, fb, s_cfg.spp, s_cfg.scene)
    png = os.path.join(kernels.BUILD_DIR, "chip_smoke_cornell_stress.png")
    save_image(png, fb)
    mrays = s_cfg.width * s_cfg.height * s_cfg.spp * (2 * s_cfg.max_depth - 1) / dt / 1e6
    print(f"forward: {mrays:.3f} Mrays/s (19 rays per sample) on {kind} [{card}], host build {host_build_s:.2f} s; "
          f"image -> {os.path.relpath(png)}")

    # --- phase 9: K2 path against the plain path, with two sphere lights ---
    small = RenderConfig(**dict(STRESS, stress_boxes=40, stress_spheres=20, intersect_impl="cull"),
                         stress_sphere_lights=2, width=16, height=16, spp=2)
    cuda_vs_cpu(np, small, build_color_tables(small, device=dev), dev, torch)

    # --- phases 10 and 11: the fused bounce and the texel gather ---
    s1_record = bounce_phase(torch, s1)
    gather_record = gather_phase(torch, tg)

    print(json.dumps({"kernels": [record, k2_record, s1_record, gather_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
