#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  In order, it

1. prints the card's name and power limit and builds the five kernels from
   source, one nvcc each, started together: K1
   (simple_spectral_torch/csrc/intersect_best_key.cu), K2 (csrc/cull_best.cu),
   S1 (csrc/bounce_fused.cu), gather_u32 (csrc/gather_u32.cu) and T1
   (csrc/threefry.cu);
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
12. runs bench.py's BASELINE configuration 3 through K1: cornell-srgb, meng,
   CIE 2006, 256x256, depth 10, explicit light sampling, u32 texels; K1
   against its twin key for key at this path's shape (the scene's
   triangles, random, camera and bounce rays at 262144 lanes, both key
   widths); ``forward_backward_step`` at the bench's 262144 lanes (pixels
   wrapping), checking 18 K1 launches and none of K2, a finite loss and finite
   gradients, with its forward+backward and forward Mrays/s (one round of 3
   calls) and peak device memory; ``render_image`` at 256x256, 4 spp, with
   K1's launch count, a finite framebuffer and the alpha coverage, the PNG
   under simple_spectral_torch/_build/ and the forward Mrays/s; and a
   16x16, 2 spp frame on the card against the CPU within the flip bound, in
   both texel formats ("u32" and "rows");
13. the same for configuration 4: plane-srgb, jakob, 512x512, depth 10,
   without explicit light sampling (K1 launches max_depth times per sample,
   10 rays per sample), u32 texels, and prints the time of the q32 texel
   precompute (the cube fetch of the 262144 texels on the card and the host
   pack);
14. runs the CLI's own path, ``ProgressiveRenderer`` with the native
   accumulator, on the main path's configuration at 512x512 and 8 spp in
   passes of 4: checks 18 x 8 K1 launches and none of K2, that a native
   checkpoint written after pass 1 (under simple_spectral_torch/_build/)
   and resumed by a fresh renderer gives a mean equal bit for bit to the
   uninterrupted render's, and that the numpy accumulator gives the same
   mean; then runs the CLI itself on the card (``--checkpoint``,
   ``--pass-spp 4``, ``--metrics-json -``), checks that its JSON line has
   ``RenderMetrics``' keys and that its checkpoint holds the same mean; prints
   the progressive forward Mrays/s (``RenderMetrics``), the wall time of each
   pass and the native checkpoint's write and wait times; and holds a 16x16
   progressive render on the card against the CPU within the flip bound;
15. on the scale path's scene (phase 7), walks the BVH arm over 262144
   bounce rays and holds its winners against the exact dense route (K1's
   exact key with the sphere sweep: equal hits and distances bit for bit,
   other winners only at exact ties) and against the cull route (K2: other
   winners only at ties inside its quantized key), printing the walk's step
   count and its ms per sweep; renders a 64x64, 1 spp, depth 3 image
   through the BVH arm, with its time; and runs one 64x64 cornell-srgb
   chunk under ``debug_checks``, which must trace clean, equal the
   unchecked chunk and launch K1;
16. runs the parallel path (simple_spectral_torch/parallel/): (a) BASELINE
   configuration 5 (tools/cfg5_r05.py: cornell-srgb 1024x1024, CIE 1931,
   depth 10, ELS; 256 spp cut to 4) in each of rgb, mallett, meng and jakob
   through ``render_accumulate_sharded`` on the card's 1x1 mesh, checking
   K1's launches (18 per sample and chunk: 72, 72, 288 for meng's four
   2^18-lane chunks, 72) and none of K2, a finite framebuffer and the alpha
   coverage, with the forward Mrays/s and peak memory of each, K1 held
   against its twin on the scene's triangles at 2^20 random, camera and
   bounce rays (both key widths, ignore on and off), and for mallett
   ``render_image`` on the same frame in turns; (b) the sharded
   train step at bench.py's call on that mesh (18 K1 launches, a finite
   loss, a non-zero emission gradient), timed by ``bench.bench_config`` in
   turns with ``forward_backward_step``; (c) a 4x2 mesh of eight shards on
   the one card at 64x64, depth 3: the sharded step at 4 spp against
   ``emulated_loss_and_grad`` within the dry run's bound and against the
   same mesh on the CPU within phase 4's bound, 2 spp sharded and
   unsharded renders over eight seeds against the CPU within the flip
   bound (at most six pixels of a render off by rel >= 0.5), and the
   sharded chunk equal to its shards' own renders bit for bit; (d) a world of one process on
   NCCL (``init_distributed``): ``render_accumulate_multihost`` at 512x512
   and 4 spp equal to ``render_accumulate_sharded`` bit for bit, the time
   of one chunk's gather, the CLI with ``--coordinator``, and the CLI with
   ``--sharded --checkpoint`` resuming after one pass, bit for bit;
17. runs the scaling path, the scaling bench
   (simple_spectral_torch/tools/scaling_bench.py) through its entry point
   on the main path's configuration at 65536 lanes per device and 1 spp:
   ``--equal-work --repeat 4`` (262144 lanes on a one-device mesh, then on
   four shards of the one card) and the in-process weak-scaling rows for
   the cards present (one card: k = 1 alone).  Each call must launch K1 18
   x spp x shards times and give a finite loss and finite gradients (the
   bench raises otherwise); it prints each JSON and holds K1 against its
   twin at a shard's 65536 rays;
18. runs the render measurement tools (simple_spectral_torch/tools/) through
   their entry points at reduced sizes: ``perf_ablate`` group fwd (nine
   forward rows, 2 timed calls each), ``stress_render`` at 1000 boxes (the
   cull arm through K2 and the dense arm through K1), ``cfg5``'s card part
   at 1024x1024 and 4 spp in mallett, and ``perf_modes`` cfg3 in both texel
   formats and without its texture; each must exit 0 with no error row,
   write the JAX tool's keys, and launch K1 and K2 per call as many times
   as its path sweeps (2 max_depth - 2 with explicit light sampling,
   max_depth without) and no other; then holds K1 against its twin (exact
   key, the twin in slices) on 262144 random, camera and bounce rays over
   the stress scene's 10,038 triangles (1000 boxes) and 50,038 (5000), and
   K2 at 10000 boxes (100,038 triangles, 500 spheres) on the path's sorted
   bounce rays at 262144 lanes and 4096 random and camera rays in both
   orders, timing K1 and K2 there beside their bounds;
19. runs the intersection benches (simple_spectral_torch/tools/) through
   their entry points at reduced sizes, 2 timed calls per row:
   ``cull_micro`` at 1000 boxes (both ray sets, each after its parity check
   of K2's route against K1's, which must pass), ``cull_cluster`` at 1000
   boxes, depth 3, cluster sizes 63 and 15, ``intersect_micro`` at its full
   T = 38 and 262144 rays, and ``bvh_micro`` at 0 and 100 boxes; each must
   exit 0 with no error row, write the JAX tool's keys and the card's
   name, and launch K1 and K2 per call as many times as its path sweeps and
   no other; then rebuilds phase 7's scene with its clusters at L = 31 and
   L = 15 (tiles of 32 and 16 rows, which the card had not run) and holds
   K2 against its twin there (the path's sorted bounce rays at 262144
   lanes, 4096 random and camera rays in both orders), timing K2 beside its
   bound at each L;
20. runs the stage and host benches (simple_spectral_torch/tools/) through
   their entry points at reduced sizes: ``diag_cfg1`` at 16384 lanes and
   depth 3, ``bwd_bisect`` at 64x64 and depth 3 (all five rows, the stubs
   in place), ``texture_micro``, ``pack_micro``, ``gather_micro`` and
   ``ctx_gather`` at 16384 indices per bounce, 2 timed calls per row; each
   must exit 0 with no error row, write its keys and the card's name, and
   launch K1 per call as many times as its path sweeps (a sample's sweeps
   for ``diag_cfg1``, four samples' for ``bwd_bisect``, none for the gather
   benches) and K2 never; then ``texel_q32_check`` on the top-left 64x64
   texels on the card and on the CPU, whose figures must agree within the
   bound that the words the two packs moved give
   (``texel_q32_check.bounds``);
21. fits the Jakob-Hanika coefficient cube on the card in float64
   (simple_spectral_torch/tools/fit_jakob_coeffs.py) at res 64, its full
   width, and at res 16, with the seconds of each component, the launches,
   the device's busy time per slice, the peak device memory and the FP64
   bound; holds each against the shipped jakob2019-srgb-{64,16}.npz under
   the fit's yardstick (``fit_jakob_coeffs.misses``: texels and nodes that
   moved, the worst excess of a node's rgb error, the max error), printing
   every figure; evaluates 1024 random sRGB colours, and the colours of the
   texels that moved, through the cube fetch and the sigmoid on the card's
   res-64 table and on the shipped one (finite, within [0, 1]; the largest
   and median difference printed, not bounded: a texel in another basin
   has another spectrum of the same colour); and exports the card's table
   to a ``.coeff`` file (magic, res and size checked);
22. holds T1, the threefry draw (random.py), against its int64 twins on the
   card bit for bit in its three epilogues (bits, uniform, and randint at
   the light choice's bounds and at the widest) at 262144 and 2097152
   elements under two keys; times each beside its bound (instruction issue,
   the INT32 pipe or bytes) and the twin's time, the card's alone and
   host-inclusive; and runs the main path's train step (phase 3's call),
   checking that T1 launched once per uniform, random_bits and randint call
   of the step;
23. prints the total wall time, one JSON line describing every kernel (K1's
   and K2's records add their launches on each path they carry,
   ``launches_by_path``, and their twin checks at the shapes of phases 12,
   13, 16a, 17, 18 and 19, ``held_by_path``), then the result line.

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
# the CLI's own path: the main path's configuration through the progressive
# renderer, 8 spp in passes of 4 (the CLI's default pass size)
PROGRESSIVE_SPP, PROGRESSIVE_PASS_SPP = 8, 4
# the parallel path: BASELINE configuration 5 (tools/cfg5_r05.py:54-56,
# cornell-srgb 1024^2, all four modes, CIE 1931, depth 10, ELS), 256 spp cut
# to 4, on the one card's 1x1 mesh
CFG5 = dict(scene="cornell-srgb", observer=1931, n_wavelengths=4, max_depth=10, els=True, width=1024, height=1024,
            spp=4)
CFG5_MODES = ("rgb", "mallett", "meng", "jakob")
# the dry run's bound: the sharded step against its single-device emulation
# (__graft_entry__.py, simple_spectral_torch/parallel/dryrun.py)
DRYRUN_LOSS_RTOL, DRYRUN_GRAD_ATOL = 2e-5, 3e-5
# the 4x2 mesh's 64x64, 2-spp render against the CPU: the seeds, and the
# pixels of one render that may differ by rel >= 0.5.  The flip bound of
# tests/test_parallel.py allows none at 8x8 and 8 spp, where a pixel
# averages eight paths; at 2 spp one flipped path is half a pixel, and the
# unsharded render_accumulate of these frames has up to 6 such pixels on an
# H100 (3, 0, 2, 4, 3, 0, 6, 5 over these seeds), so each render may have 6
FLIP_SEEDS, FAR_FLIPS_ALLOWED = tuple(range(3, 11)), 6
# the scaling path: the scaling bench on the main path's configuration at
# 65536 lanes per device and 1 spp; --equal-work on four entries of one card
SCALING_LANES, SCALING_SPP, SCALING_REPEAT = 65536, 1, 4
# the render measurement tools through their entry points, cut to about a
# minute together: timed calls per row, the stress tool's box count, and
# cfg5's one mode and spp
TOOLS_CALLS, TOOLS_STRESS_BOXES, TOOLS_CFG5 = 2, 1000, ("mallett", 4)
# the intersection benches through their entry points, cut: timed calls per
# row, the box counts of the cull micro-bench and the cluster sweep, the
# sweep's depth, and the BVH walk's sizes; then K2 against its twin at the
# cluster sizes the card had not run
INTERSECT_CALLS, INTERSECT_BOXES, INTERSECT_DEPTH = 2, 1000, 3
INTERSECT_CLUSTER_SIZES, INTERSECT_BVH_BOXES, K2_NEW_CLUSTER_SIZES = (63, 15), (0, 100), (31, 15)
# the stage and host benches through their entry points, cut: diag_cfg1's
# lanes and depth, bwd_bisect's frame side and depth, the texel check's crop,
# the gather benches' indices per bounce, and timed calls per row
STAGE_LANES, STAGE_DEPTH, STAGE_SIZE, STAGE_CROP, STAGE_N, STAGE_CALLS = 16384, 3, 64, 64, 16384, 2
# the texel check's figures on the card against the CPU: both are the port's,
# so they agree as its q32 words and decodes do (texel_q32_check.bounds),
# the decodes within 2e-6 (the q32 decode's departure from JAX's, held in
# tests/test_torch_jakob.py)
STAGE_DECODE_ATOL = 2e-6
# the jakob fit: the shipped table's width, uncut, and the res-16 table the
# CPU tests hold the port to; the random colours through the card's table
JAKOB_FIT_RES, JAKOB_CHECK_RES = 64, 16
JAKOB_COLOURS, JAKOB_SEED = 1024, 21
# kernel T1, the threefry draw: the jakob render's chunk of 262144 lanes and
# the 2M-lane train cell's; randint at the light choice's bounds and the
# widest.  Its bound, the largest of three: its operations per element as
# csrc/threefry.cu counts them (72 a hash; uniform 4 more; randint two
# hashes, a multiply, two adds and three moduli by a runtime width, ~10
# each) over the H100's instruction issue (132 SMs x 4 schedulers x 32
# lanes x 1.98 GHz, at 700 W); those of them only the 64-lane INT32 pipe
# runs (a hash's 20 rotates and 21 xors; uniform's shift and or) over that
# pipe's rate; the bytes it stores over 3.35 TB/s
T1_SIZES = (262144, 2097152)
T1_DRAWS = (("bits", None), ("uniform", None), ("randint", (0, 5)), ("randint", (-2**31, 2**31 - 1)))
T1_OPS = {"bits": (72, 41), "uniform": (76, 43), "randint": (177, 82)}
T1_BYTES = {"bits": 8, "uniform": 4, "randint": 4}
H100_ISSUE_PER_S, H100_INT32_PIPE_PER_S = 132 * 128 * 1.98e9, 132 * 64 * 1.98e9
SCALING_JAX_KEYS = {"equal-work": {"backend", "device", "protocol", "total_lanes", "spp", "sharded_over_single",
                                   "results"},
                    "weak": {"backend", "device", "lanes_per_dev", "spp", "results"}}


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


def hold_k1(torch, k1, name, tv, tp, o, d, ig, n_tris, eps, exact, chunk=None):
    """K1 against its twin on one ray set, key for key; fails on any
    difference.  With ``chunk`` the twin runs on that many rays at a time
    (its [T, N] grid at tens of thousands of triangles would not fit at
    once); K1 runs on all of them.  Returns the largest key difference (0)."""
    from simple_spectral_torch.render.vec import V3

    width = "exact 64-bit" if exact else "quantized 32-bit"
    got = k1.intersect_best_key(tv, tp, o, d, ig, eps, exact)
    n = o.x.shape[0]
    step = chunk or n
    want = torch.cat([k1.best_key_plain(tv, tp, V3(*(c[i:i + step] for c in o)), V3(*(c[i:i + step] for c in d)),
                                        ig[i:i + step], eps, exact) for i in range(0, n, step)])
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    hits = int(k1.key_parts(got, n_tris, exact)[0].sum())
    print(f"K1 vs twin, {width} key: {name:7s} T={n_tris:5d} N={o.x.shape[0]:6d} hits={hits:6d} "
          f"max|key diff|={err}")
    if err != 0 or got.dtype != want.dtype:
        fail(f"K1 disagrees with its twin ({width} key) on {name} rays, T={n_tris}, N={o.x.shape[0]}")
    return err


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

    for exact in (False, True):
        for name, (o, d, ign) in sets.items():
            for n in (1, 7, 2049, n_max, n_max + 1, K1_N_OVER):
                for use_ignore in (False, True):
                    oo, dd = V3(*(c[:n] for c in o)), V3(*(c[:n] for c in d))
                    ig = ign[:n] if use_ignore else torch.full((n,), -1, dtype=torch.int32, device=ign.device)
                    label = f"{name}, ignore {'on' if use_ignore else 'off'}"
                    max_err = max(max_err, hold_k1(torch, k1, label, tv, tp, oo, dd, ig, scene.n_tris, cfg.eps, exact))
    # more triangles than one tile, the last tile partial: the dense route of
    # cornell-stress at 1000 boxes (below the cull threshold)
    d_cfg = RenderConfig(scene="cornell-stress", mode="rgb", width=8, height=8, stress_boxes=1000,
                         bvh_threshold=1 << 30)
    dense = build_scene(d_cfg, build_color_tables(d_cfg, device=scene.device), device=scene.device)
    dense_sets = ray_sets(torch, np, dense, d_cfg, 2049)
    for exact in (False, True):
        for name, (o, d, ign) in dense_sets.items():
            max_err = max(max_err, hold_k1(torch, k1, f"{name}, dense", dense.tri_verts, dense.tri_prim, o, d, ign,
                                           dense.n_tris, d_cfg.eps, exact))

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
    """The cornell box leaves a rim of sky beside it; plane-srgb's box of
    lights surrounds the camera, so every camera ray hits."""
    alpha = fb[..., 3]
    h, w = alpha.shape
    quarter = (slice(h // 4, 3 * h // 4), slice(w // 4, 3 * w // 4))
    on_grid = np.abs(alpha * spp - np.round(alpha * spp)).max()
    print(f"alpha: mean {alpha.mean():.6f}, central half min {alpha[quarter].min():.3f}, "
          f"off the 1/spp grid by {on_grid:.2e}")
    if what == "plane-srgb":
        if alpha.min() != 1.0:
            fail("a camera ray missed plane-srgb's box of lights")
    elif not (0.9 < alpha.mean() < 1.0) or alpha[quarter].min() != 1.0 or on_grid > 1e-6:
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
    flip_bound(np, v_gpu, a_gpu, v_cpu, a_cpu, f"{cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp")


def flip_bound(np, v_gpu, a_gpu, v_cpu, a_cpu, what, far_allowed=0):
    """The card's image against the CPU's within the flip bound of
    tests/test_parallel.py scaled to the frame: at most 1/16 of the pixels
    off by rel >= 1e-3, at most ``far_allowed`` of them by rel >= 0.5 (the
    bound's cap: one path's share of a pixel), means to 2e-3, alpha
    exactly.  Returns (pixels at rel >= 0.5, worst rel)."""
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    far = int((~(rel < 0.5).all(axis=-1)).sum())
    n_px = rel.shape[0] * rel.shape[1]
    mean_rel = np.abs(v_gpu.mean(axis=(0, 1)) / v_cpu.mean(axis=(0, 1)) - 1.0).max()
    print(f"{what} cuda vs cpu: {flipped}/{n_px} pixels differ by rel >= 1e-3, {far} by rel >= 0.5 (at most "
          f"{far_allowed}), worst rel {rel.max():.3e}, means rel {mean_rel:.3e}, alpha equal "
          f"{np.array_equal(a_gpu, a_cpu)}")
    if flipped > n_px // 16 or far > far_allowed or mean_rel > 2e-3 or not np.array_equal(a_gpu, a_cpu):
        fail(f"{what}: the card and the CPU disagree beyond the flip bound")
    return far, float(rel.max())


def sweeps_per_sample(cfg) -> int:
    """K1 sweeps per sample: 2 max_depth - 2 with explicit light sampling
    (the final sweep is skipped), max_depth without."""
    return 2 * cfg.max_depth - 2 if cfg.els else cfg.max_depth


def train_step_phase(torch, np, scene, tables, cfg, k1, k2, lanes=None, rounds=TRAIN_ROUNDS):
    """Phases 3, 12 and 13: bench.py's forward_backward_step call on the
    card, at ``lanes`` lanes (the frame's pixels by default; more wrap).
    Returns K1's launches in one call."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.bench import bench_config
    from simple_spectral_torch.render.trainstep import forward_backward_step, forward_only_step

    dev = scene.device
    n = lanes or cfg.width * cfg.height
    px = torch.arange(n, dtype=torch.int32, device=dev) % (cfg.width * cfg.height)
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
    expect = sweeps_per_sample(cfg)
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

    mrays = [bench_config(cfg, tables, scene, rnd.fold_in(key, 1 + r), 1, TRAIN_CALLS, n) for r in range(rounds)]
    fwd = bench_config(cfg, tables, scene, rnd.fold_in(key, 1 + rounds), 1, TRAIN_CALLS, n,
                       step_fn=forward_only_step)
    per_sample = 2 * cfg.max_depth - 1 if cfg.els else cfg.max_depth
    rays = n * per_sample
    mid = statistics.median(mrays)
    print(f"forward+backward {cfg.scene} {cfg.mode}: {mid:.3f} Mrays/s ({per_sample} rays per sample; median of "
          f"{rounds} rounds of {TRAIN_CALLS} calls, spread {min(mrays):.3f}-{max(mrays):.3f}; "
          f"{rays / mid / 1e3:.3f} ms per call); forward only {fwd:.3f} Mrays/s ({rays / fwd / 1e3:.3f} ms per "
          f"call, one round of {TRAIN_CALLS}); peak device memory {peak_gb:.3f} GB")
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


def colour_phase(torch, np, name, k1, k2, kind, card):
    """Phases 12 and 13: one of bench.py's BASELINE configurations 3 (meng)
    and 4 (jakob) at depth 10 with u32 texels, through K1: the train step at
    the bench's lanes, render_image at the configuration's size and 4 spp,
    and the card against the CPU in both texel formats; K1 against its twin
    at the path's shape.  Returns K1's launches in the train step's call and
    in the render, and the twin check's record."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.bench import BASELINE_CONFIGS, BENCH_LANES
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.render.renderer import render_chunk_lanes, render_image
    from simple_spectral_torch.scene import library
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    kw = {k: v for k, v in BASELINE_CONFIGS[name].items() if k not in ("spp", "spp_chunk")}
    cfg = RenderConfig(**kw, spp=SPP, max_depth=10, texel_format="u32")
    dev = torch.device("cuda")
    tables = build_color_tables(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    scene = library.build_scene(cfg, tables, device=dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    text = ""
    if cfg.mode == "jakob":
        # the q32 texel precompute alone, run once more: the cube fetch of
        # every texel on the card, then the host pack
        texture = library.scene_texture(cfg)
        torch.cuda.synchronize()
        t0 = time.time()
        library.texel_jakob_q32(tables.jakob, texture, dev)
        torch.cuda.synchronize()
        n_texels = texture.shape[0] * texture.shape[1]
        text = f"; the q32 texel precompute of {n_texels} texels alone {time.time() - t0:.3f} s"
    print(f"{name}: {cfg.scene} built in {build_s:.3f} s{text} ({scene.n_tris} triangles, texture "
          f"{tuple(scene.texture.shape)} {scene.texture.dtype})", flush=True)

    # K1 against its twin at this path's shape: the scene's T triangles and
    # the bench's lanes, both key widths
    held = 0
    for exact in (False, True):
        for set_name, (o, d, ign) in ray_sets(torch, np, scene, cfg, BENCH_LANES).items():
            held = max(held, hold_k1(torch, k1, f"{set_name}, {cfg.scene}", scene.tri_verts, scene.tri_prim, o, d,
                                     ign, scene.n_tris, cfg.eps, exact))

    train = train_step_phase(torch, np, scene, tables, cfg, k1, k2, lanes=BENCH_LANES, rounds=1)

    render_image(cfg.replace(width=64, height=64, spp=1), scene, tables, device=dev)  # warm-up
    torch.cuda.synchronize()
    chunks = -(-(cfg.width * cfg.height) // render_chunk_lanes(cfg, scene))
    k1.LAUNCHES = k2.LAUNCHES = 0
    t0 = time.time()
    fb = render_image(cfg, scene, tables, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
    expect = sweeps_per_sample(cfg) * cfg.spp * chunks
    print(f"render_image {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp {cfg.mode} {cfg.observer} depth "
          f"{cfg.max_depth} els {cfg.els}: {dt:.3f} s, K1 launches {launches} (expected {expect}), K2 launches "
          f"{k2_launches}")
    if launches != expect or k2_launches != 0:
        fail(f"K1 launched {launches} times (expected {expect}) and K2 {k2_launches} (expected 0) on {name}")
    if fb.shape != (cfg.height, cfg.width, 4) or not np.isfinite(fb).all():
        fail(f"framebuffer not finite or of shape {fb.shape} ({name})")
    check_alpha(np, fb, cfg.spp, cfg.scene)
    png = os.path.join(kernels.BUILD_DIR, f"chip_smoke_{cfg.scene}_{cfg.mode}.png")
    save_image(png, fb)
    per_sample = 2 * cfg.max_depth - 1 if cfg.els else cfg.max_depth
    mrays = cfg.width * cfg.height * cfg.spp * per_sample / dt / 1e6
    print(f"forward: {mrays:.3f} Mrays/s ({per_sample} rays per sample) on {kind} [{card}]; image -> "
          f"{os.path.relpath(png)}")

    for fmt in ("u32", "rows"):
        cuda_vs_cpu(np, cfg.replace(width=16, height=16, spp=2, texel_format=fmt), tables, dev, torch)
    return train, launches, {"T": scene.n_tris, "N": BENCH_LANES, "max_abs_err": held}


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


def progressive_phase(torch, np, scene, tables, cfg, k1, k2, kind, card):
    """Phase 14: the CLI's own path at full width.  Returns K1's launches in
    the uninterrupted render."""
    import contextlib
    import io

    from simple_spectral_torch import kernels
    from simple_spectral_torch.cli import main as cli_main
    from simple_spectral_torch.render.progressive import ProgressiveRenderer
    from simple_spectral_torch.utils.metrics import RenderMetrics

    cfg = cfg.replace(spp=PROGRESSIVE_SPP)

    def renderer(**kw):
        return ProgressiveRenderer(cfg, scene, tables, seed=0, spp_per_pass=PROGRESSIVE_PASS_SPP, **kw)

    whole = renderer(native=True)
    torch.cuda.synchronize()
    k1.LAUNCHES = k2.LAUNCHES = 0
    whole.run()
    launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
    expect = sweeps_per_sample(cfg) * cfg.spp
    m = whole.metrics
    print(f"progressive {cfg.scene} {cfg.width}x{cfg.height}@{cfg.spp}spp in passes of {PROGRESSIVE_PASS_SPP} "
          f"(native accumulator): K1 launches {launches} (expected {expect}), K2 launches {k2_launches}; forward "
          f"{m.mrays_per_s:.3f} Mrays/s (RenderMetrics, {m.rays_traced} rays in {m.wall_s:.4f} s), wall s per pass "
          f"{', '.join(f'{t:.4f}' for t in m.pass_times)} on {kind} [{card}]", flush=True)
    if launches != expect or k2_launches != 0:
        fail(f"the progressive render launched K1 {launches} times (expected {expect}) and K2 {k2_launches}")
    value, alpha = whole.mean_value()
    if value.shape != (cfg.height, cfg.width, 3) or not np.isfinite(value).all():
        fail("the progressive mean is not finite or of the wrong shape")
    check_alpha(np, np.concatenate([value, alpha[..., None]], axis=-1), cfg.spp, cfg.scene)

    ckpt = os.path.join(kernels.BUILD_DIR, "chip_smoke_progressive.ckpt")
    first = renderer(native=True, checkpoint_path=ckpt)
    first.run_pass()
    t0 = time.time()
    first.save_checkpoint(wait=False)
    write_s = time.time() - t0
    t0 = time.time()
    ok = first._fb.checkpoint_wait()  # the pending write of the native accumulator
    wait_s = time.time() - t0
    resumed = renderer(native=True, checkpoint_path=ckpt)
    if not ok or not resumed.resume() or resumed.spp_done != PROGRESSIVE_PASS_SPP:
        fail("the native checkpoint after pass 1 was not written or not resumed")
    resumed.run()
    numpy_acc = renderer(native=False)
    numpy_acc.run()
    same_resume = all(np.array_equal(a, b) for a, b in zip(resumed.mean_value(), (value, alpha)))
    same_numpy = all(np.array_equal(a, b) for a, b in zip(numpy_acc.mean_value(), (value, alpha)))
    print(f"native checkpoint of {cfg.width}x{cfg.height} after pass 1: write call {write_s * 1e3:.3f} ms, wait "
          f"{wait_s * 1e3:.3f} ms ({os.path.getsize(ckpt)} bytes) on {kind} [{card}]; resumed mean equal bit for bit "
          f"{same_resume}; numpy accumulator's mean equal bit for bit {same_numpy}")
    if not (same_resume and same_numpy):
        fail("the resumed or the numpy-accumulated progressive mean differs from the uninterrupted native one")

    cli_ckpt = os.path.join(kernels.BUILD_DIR, "chip_smoke_cli.ckpt")
    for path in (cli_ckpt, cli_ckpt + ".meta.json"):
        if os.path.exists(path):
            os.remove(path)
    png = os.path.join(kernels.BUILD_DIR, "chip_smoke_cli.png")
    argv = ["-s", cfg.scene, "-w", str(cfg.width), "-h", str(cfg.height), "-spp", str(cfg.spp), "--mode", cfg.mode,
            "--observer", str(cfg.observer), "--wavelengths", str(cfg.n_wavelengths), "--max-depth",
            str(cfg.max_depth), "--pass-spp", str(PROGRESSIVE_PASS_SPP), "--checkpoint", cli_ckpt,
            "--metrics-json", "-", "--quiet", "-o", png]
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    cli_s = time.time() - t0
    line = json.loads(out.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
    from_cli = renderer(native=True, checkpoint_path=cli_ckpt)
    same_cli = from_cli.resume() and all(np.array_equal(a, b) for a, b in zip(from_cli.mean_value(), (value, alpha)))
    print(f"cli {' '.join(argv)}: rc {rc} in {cli_s:.3f} s (scene build included); metrics {json.dumps(line)}; "
          f"its checkpoint's mean equal to the renderer's bit for bit {same_cli}")
    if rc != 0 or line.keys() != RenderMetrics(cfg).to_dict().keys() or line["spp"] != cfg.spp or not same_cli:
        fail("the CLI's progressive render failed, or its metrics or checkpoint are not the renderer's")

    small = cfg.replace(width=16, height=16, spp=4)
    means = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        pr = ProgressiveRenderer(small, seed=3, spp_per_pass=2, native=False, device=dev)
        pr.run()
        means.append(pr.mean_value())
    flip_bound(np, *means[0], *means[1], "progressive 16x16@4spp")
    return launches


def bvh_phase(torch, np, s_scene, s_tables, s_cfg, scene, tables, cfg, k1, k2, kind, card):
    """Phase 15: the BVH arm against K1's and K2's routes on the scale
    path's scene, one render through it, and a debug-checked chunk.
    Returns K1's launches in the checked chunk."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.render import bvh
    from simple_spectral_torch.render.intersect import intersect_rays_dispatch
    from simple_spectral_torch.render.renderer import _render_chunk, render_image

    n = WIDTH * HEIGHT
    o, d, ign = ray_sets(torch, np, s_scene, s_cfg, n)["bounce"]
    torch.cuda.synchronize()
    t0 = time.time()
    entry, dist, steps = bvh.bvh_walk(s_scene, o, d, ign, s_cfg.eps)
    torch.cuda.synchronize()
    walk_s = time.time() - t0
    got = bvh.intersect_rays_bvh(s_scene, o, d, ign, s_cfg.eps)
    dense = intersect_rays_dispatch(s_scene, o, d, ign, s_cfg.eps, impl="xla")
    culled = intersect_rays_dispatch(s_scene, o, d, ign, s_cfg.eps, impl="cull")
    torch.cuda.synchronize()
    hits = int(got.hit.sum())
    dense_ties = int(((got.prim != dense.prim) | (got.tri != dense.tri)).sum())
    other = (got.prim != culled.prim) | (got.tri != culled.tri)
    # K2's key keeps the distance's bits above the low 6: other winners must tie there
    in_key = bool((got.dist.view(torch.int32)[other] >> 6 == culled.dist.view(torch.int32)[other] >> 6).all())
    key_ties = int(other.sum())
    print(f"BVH walk on {s_scene.n_tris} triangles, {s_scene.n_spheres} spheres ({s_scene.n_bvh_entries} entries), "
          f"{n} bounce rays: {steps} steps, {walk_s * 1e3:.3f} ms per sweep ({walk_s * 1e3 / steps:.4f} ms per step, "
          f"host clock, eager, one host read per step) on {kind} [{card}]; {hits} hits; against the exact dense route "
          f"(K1 + spheres): hits equal {torch.equal(got.hit, dense.hit)}, distances equal bit for bit "
          f"{torch.equal(got.dist, dense.dist)}, {dense_ties} other winners; against the cull route (K2): hits equal "
          f"{torch.equal(got.hit, culled.hit)}, {key_ties} other winners, all inside K2's quantized key {in_key}",
          flush=True)
    if not (torch.equal(got.hit, dense.hit) and torch.equal(got.dist, dense.dist) and torch.equal(dist, got.dist)):
        fail("the BVH walk's hits or distances differ from the exact dense route's")
    if not torch.equal(got.hit, culled.hit) or not in_key:
        fail("the BVH walk's winners differ from the cull route's beyond ties inside K2's quantized key")

    b_cfg = s_cfg.replace(width=64, height=64, spp=1, max_depth=3, intersect_impl="bvh")
    k1.LAUNCHES = k2.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    fb = render_image(b_cfg, s_scene, s_tables, seed=0, device=s_scene.device)
    torch.cuda.synchronize()
    render_s = time.time() - t0
    print(f"render_image through the BVH arm, {b_cfg.scene} {b_cfg.width}x{b_cfg.height}@1spp depth "
          f"{b_cfg.max_depth}: {render_s:.3f} s on {kind} [{card}], K1 launches {k1.LAUNCHES}, K2 launches "
          f"{k2.LAUNCHES}")
    if fb.shape != (64, 64, 4) or not np.isfinite(fb).all() or k1.LAUNCHES or k2.LAUNCHES:
        fail("the BVH render is not finite, or launched K1 or K2")
    check_alpha(np, fb, 1, b_cfg.scene)

    c_cfg = cfg.replace(width=64, height=64, debug_checks=True)
    px = torch.arange(64 * 64, dtype=torch.int32, device=scene.device)
    k1.LAUNCHES = 0
    t0 = time.time()
    checked = _render_chunk(scene, tables, c_cfg, rnd.PRNGKey(5), px, 1)
    torch.cuda.synchronize()
    checked_s = time.time() - t0
    launches = k1.LAUNCHES
    plain = _render_chunk(scene, tables, c_cfg.replace(debug_checks=False), rnd.PRNGKey(5), px, 1)
    same = all(torch.equal(a, b) for a, b in zip(checked, plain))
    print(f"debug-checked chunk {c_cfg.scene} 64x64@1spp depth {c_cfg.max_depth}: clean in {checked_s:.3f} s, K1 "
          f"launches {launches}, equal to the unchecked chunk bit for bit {same}")
    if launches != sweeps_per_sample(c_cfg) or not same:
        fail("the debug-checked chunk did not launch K1 per sweep or differs from the unchecked one")
    return launches


def grads_apart(np, grads, grads1):
    """Each gradient's largest difference over the reference's largest entry."""
    out = {}
    for f, g1 in grads1.items():
        g, g1 = grads[f].cpu().numpy(), g1.cpu().numpy()
        out[f] = float(np.abs(g - g1).max() / max(np.abs(g1).max(), 1e-8))
    return out


def parallel_phase(torch, np, scene, tables, cfg, k1, k2, kind, card):
    """Phase 16: the parallel path (simple_spectral_torch/parallel/).
    Returns K1's launches on each of its paths and its twin check at
    configuration 5's shape."""
    import contextlib
    import io
    import socket

    import torch.distributed as dist

    from simple_spectral_torch import kernels
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.bench import bench_config
    from simple_spectral_torch.cli import main as cli_main
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.io.image import save_image
    from simple_spectral_torch.parallel.multihost import global_mesh, init_distributed, render_accumulate_multihost
    from simple_spectral_torch.parallel.sharding import (emulated_loss_and_grad, make_mesh, render_accumulate_sharded,
                                                         sharded_loss_and_grad, sharded_sample_sums)
    from simple_spectral_torch.render.progressive import ProgressiveRenderer
    from simple_spectral_torch.render.renderer import (_render_chunk, finalize_srgb, render_accumulate,
                                                       render_chunk_lanes, render_image)
    from simple_spectral_torch.render.trainstep import forward_backward_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    dev = scene.device
    by_path = {}
    t_phase = time.time()

    # (a) BASELINE configuration 5 at full width on the 1x1 mesh
    mesh = make_mesh()
    if mesh.shape != {"dp": 1, "sp": 1}:
        fail(f"make_mesh() on one card is {mesh.shape}, not 1x1")
    for mode in CFG5_MODES:
        c5 = RenderConfig(**CFG5, mode=mode)
        t5 = build_color_tables(c5, device=dev)
        s5 = build_scene(c5, t5, device=dev)
        render_accumulate_sharded(c5.replace(width=64, height=64, spp=1), s5, t5, mesh)  # warm-up
        n_px = c5.width * c5.height
        chunks = -(-n_px // (render_chunk_lanes(c5, s5) * mesh.shape["dp"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.LAUNCHES = k2.LAUNCHES = 0
        t0 = time.time()
        value, alpha = render_accumulate_sharded(c5, s5, t5, mesh, seed=0)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expect = sweeps_per_sample(c5) * c5.spp * chunks
        mrays = n_px * c5.spp * (2 * c5.max_depth - 1) / dt / 1e6
        print(f"cfg5 render_accumulate_sharded {c5.scene} {c5.width}x{c5.height}@{c5.spp}spp {mode} on the 1x1 mesh: "
              f"{dt:.3f} s, {chunks} chunks, K1 launches {launches} (expected {expect}), K2 launches {k2_launches}; "
              f"forward {mrays:.3f} Mrays/s (19 rays per sample), peak device memory {peak_gb:.3f} GB on {kind} "
              f"[{card}]", flush=True)
        if launches != expect or k2_launches != 0:
            fail(f"cfg5 {mode}: K1 launched {launches} times (expected {expect}) and K2 {k2_launches} (expected 0)")
        fb = finalize_srgb(c5, t5, value, alpha)
        if fb.shape != (c5.height, c5.width, 4) or not np.isfinite(fb).all():
            fail(f"cfg5 {mode}: framebuffer not finite or of shape {fb.shape}")
        check_alpha(np, fb, c5.spp, c5.scene)
        save_image(os.path.join(kernels.BUILD_DIR, f"chip_smoke_cfg5_{mode}.png"), fb)
        by_path[f"render_accumulate_sharded cfg5 {mode} 1024^2 at {c5.spp} spp (phase 16a)"] = launches
        if mode == "rgb":
            # K1 against its twin at this path's shape: the scene's T
            # triangles and one chunk's 2^20 lanes, both key widths
            n_held, held = c5.width * c5.height, 0
            for exact in (False, True):
                for set_name, (o, d, ign) in ray_sets(torch, np, s5, c5, n_held).items():
                    for use_ignore in (False, True):
                        ig = ign if use_ignore else torch.full_like(ign, -1)
                        label = f"{set_name}, ignore {'on' if use_ignore else 'off'}, cfg5"
                        held = max(held, hold_k1(torch, k1, label, s5.tri_verts, s5.tri_prim, o, d, ig, s5.n_tris,
                                                 c5.eps, exact))
            held = {"T": s5.n_tris, "N": n_held, "max_abs_err": held}
        if mode == "mallett":
            # the sharded program against render_image on the same frame, in
            # turns after the checked run (which grew the allocator)
            times = {"sharded": [], "render_image": []}
            for name in ("sharded", "render_image", "render_image", "sharded"):
                torch.cuda.synchronize()
                t0 = time.time()
                if name == "sharded":
                    render_accumulate_sharded(c5, s5, t5, mesh, seed=0)
                else:
                    render_image(c5, s5, t5, seed=0, device=dev)
                torch.cuda.synchronize()
                times[name].append(time.time() - t0)
            ratio = statistics.mean(times["sharded"]) / statistics.mean(times["render_image"])
            print(f"cfg5 mallett in turns (sharded, render_image, render_image, sharded): "
                  f"{times['sharded'][0]:.3f}, {times['render_image'][0]:.3f}, {times['render_image'][1]:.3f}, "
                  f"{times['sharded'][1]:.3f} s; sharded / render_image {ratio:.4f}", flush=True)
        del s5, t5, value, alpha, fb

    # (b) the sharded train step at bench.py's call on the 1x1 mesh
    n = cfg.width * cfg.height
    px = torch.arange(n, dtype=torch.int32, device=dev)
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def sharded_step(scene_, tables_, cfg_, key, px_, target_, spp):
        return sharded_loss_and_grad(scene_, tables_, cfg_, mesh, key, px_, target_, spp)

    sharded_step(scene, tables, cfg, rnd.fold_in(rnd.PRNGKey(0), 99), px, target, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = k2.LAUNCHES = 0
    loss, grads = sharded_step(scene, tables, cfg, rnd.PRNGKey(0), px, target, 1)
    torch.cuda.synchronize()
    launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g_max = float(grads["emission_values"].abs().max())
    print(f"sharded_loss_and_grad on the 1x1 mesh, {cfg.scene} {n} lanes x 1 spp {cfg.mode} depth {cfg.max_depth}: "
          f"loss {float(loss):.6g}, K1 launches {launches} (expected {sweeps_per_sample(cfg)}), K2 launches "
          f"{k2_launches}, max |grad emission_values| {g_max:.6g}, peak device memory {peak_gb:.3f} GB")
    if launches != sweeps_per_sample(cfg) or k2_launches != 0:
        fail(f"the sharded train step launched K1 {launches} times and K2 {k2_launches}")
    if not torch.isfinite(loss) or not all(bool(torch.isfinite(g).all()) for g in grads.values()) or g_max == 0.0:
        fail("the sharded train step's loss or a gradient is not finite, or emission_values has a zero gradient")
    by_path["sharded train step 1x1 cornell-srgb mallett 512^2 (phase 16b)"] = launches
    rates = {"sharded": [], "forward_backward_step": []}
    for r, name in enumerate(("sharded", "forward_backward_step", "forward_backward_step", "sharded")):
        fn = sharded_step if name == "sharded" else forward_backward_step
        rates[name].append(bench_config(cfg, tables, scene, rnd.fold_in(rnd.PRNGKey(0), 1 + r), 1, TRAIN_CALLS, n,
                                        step_fn=fn))
    print(f"forward+backward in turns (sharded, forward_backward_step, forward_backward_step, sharded; "
          f"{TRAIN_CALLS} calls each, bench.bench_config): {rates['sharded'][0]:.3f}, "
          f"{rates['forward_backward_step'][0]:.3f}, {rates['forward_backward_step'][1]:.3f}, "
          f"{rates['sharded'][1]:.3f} Mrays/s (19 rays per sample) on {kind} [{card}]", flush=True)

    # (c) a 4x2 mesh of eight shards on the one card, at 64^2 and depth 3
    cc = cfg.replace(width=64, height=64, spp=4, max_depth=3)
    n = cc.width * cc.height
    tgt = np.random.default_rng(3).uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    out = []
    k1.LAUNCHES = 0
    for d in (dev, torch.device("cpu")):
        tc = build_color_tables(cc, device=d)
        sc = build_scene(cc, tc, device=d)
        m8 = make_mesh([d] * 8, sp=2)
        px = torch.arange(n, dtype=torch.int32, device=d)
        target = torch.from_numpy(tgt).to(d)
        t0 = time.time()
        loss, grads = sharded_loss_and_grad(sc, tc, cc, m8, rnd.PRNGKey(3), px, target, cc.spp)
        step_s = time.time() - t0
        if not out:  # the card
            launches = k1.LAUNCHES
            loss1, grads1 = emulated_loss_and_grad(sc, tc, cc, 4, 2, rnd.PRNGKey(3), px, target, cc.spp)
            loss_rel = abs(float(loss) / float(loss1) - 1.0)
            apart = grads_apart(np, grads, grads1)
            print(f"sharded_loss_and_grad on a 4x2 mesh of {d} x 8, {cc.width}x{cc.height}@{cc.spp}spp depth "
                  f"{cc.max_depth}: {step_s:.3f} s, K1 launches {launches} (expected "
                  f"{8 * sweeps_per_sample(cc) * cc.spp // 2}); against emulated_loss_and_grad on the card: loss "
                  f"rel {loss_rel:.3e}, scaled grad errors {apart}")
            if launches != 8 * sweeps_per_sample(cc) * cc.spp // 2:
                fail(f"the 4x2 sharded step launched K1 {launches} times")
            if loss_rel > DRYRUN_LOSS_RTOL or max(apart.values()) > DRYRUN_GRAD_ATOL:
                fail(f"the 4x2 sharded step on the card differs from its emulation beyond loss rtol "
                     f"{DRYRUN_LOSS_RTOL} or scaled gradient atol {DRYRUN_GRAD_ATOL}")
            by_path["sharded train step 4x2 on one card 64^2 depth 3 (phase 16c)"] = launches
        out.append((float(loss), grads, sc, tc, m8))
    (l_gpu, g_gpu, *on_card), (l_cpu, g_cpu, *on_cpu) = out
    loss_rel = abs(l_gpu / l_cpu - 1.0)
    apart = grads_apart(np, g_gpu, g_cpu)
    print(f"4x2 sharded step cuda vs cpu: loss rel {loss_rel:.3e}, scaled grad errors {apart}")
    if loss_rel > TRAIN_LOSS_RTOL or max(apart.values()) > TRAIN_GRAD_ATOL:
        fail(f"the 4x2 sharded step on the card and on the CPU disagree beyond loss rtol {TRAIN_LOSS_RTOL} or "
             f"scaled gradient atol {TRAIN_GRAD_ATOL}")
    # the 2-spp render on the 4x2 mesh against the CPU's, and the unsharded
    # render of the same frame beside it, over several seeds: one flipped
    # path can move a pixel of a 2-spp frame by several times its value,
    # sharded or not, so each render may hold FAR_FLIPS_ALLOWED such pixels
    c2 = cc.replace(spp=2)
    far = {"sharded 4x2": [], "unsharded": []}
    for seed in FLIP_SEEDS:
        for how in far:
            img = [render_accumulate_sharded(c2, sc, tc, m8, seed=seed) if how == "sharded 4x2"
                   else render_accumulate(c2, sc, tc, seed=seed) for sc, tc, m8 in (on_card, on_cpu)]
            far[how].append(flip_bound(np, *img[0], *img[1], f"{how} {c2.width}x{c2.height}@2spp seed {seed}",
                                       far_allowed=FAR_FLIPS_ALLOWED))
    for how, rows in far.items():
        print(f"{how} renders over seeds {list(FLIP_SEEDS)}: pixels at rel >= 0.5 {[r[0] for r in rows]}, worst rel "
              f"{[round(r[1], 3) for r in rows]}")
    # on the card, the sharded chunk is each shard's own _render_chunk, the
    # sp partials added in order, bit for bit
    sc, tc, _ = on_card
    px = torch.arange(n, dtype=torch.int32, device=dev)
    key = rnd.fold_in(rnd.PRNGKey(3), 0)
    got_v, got_a = sharded_sample_sums(sc, tc, cc, make_mesh([dev] * 8, sp=2), key, px, 2)
    per = n // 4
    same = True
    for di in range(4):
        parts = [_render_chunk(sc, tc, cc, rnd.fold_in(rnd.fold_in(key, di), si), px[di * per:(di + 1) * per], 1)
                 for si in range(2)]
        same = same and torch.equal(got_v[di * per:(di + 1) * per], parts[0][0] + parts[1][0])
        same = same and torch.equal(got_a[di * per:(di + 1) * per], parts[0][1] + parts[1][1])
    print(f"4x2 sharded chunk on the card equal to its shards' own renders bit for bit {same}")
    if not same:
        fail("the 4x2 sharded chunk on the card is not the sum of its shards' renders")

    # (d) a world of one process on NCCL
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    if not init_distributed(f"localhost:{port}", 1, 0, device=dev):
        fail("init_distributed did not create the NCCL group")
    try:
        init_s = time.time() - t0
        gm = global_mesh()
        if dist.get_backend() != "nccl" or not gm.distributed or gm.shape != {"dp": 1, "sp": 1}:
            fail(f"the world of one is {dist.get_backend()}, distributed {gm.distributed}, mesh {gm.shape}")
        k1.LAUNCHES = 0
        t0 = time.time()
        v_mh, a_mh = render_accumulate_multihost(cfg, scene, tables, seed=0)
        torch.cuda.synchronize()
        mh_s = time.time() - t0
        launches = k1.LAUNCHES
        by_path[f"render_accumulate_multihost NCCL world of one 512^2 at {cfg.spp} spp (phase 16d)"] = launches
        v_sh, a_sh = render_accumulate_sharded(cfg, scene, tables, mesh, seed=0)
        same = np.array_equal(v_mh, v_sh) and np.array_equal(a_mh, a_sh)
        rows = {0: torch.zeros((1 << 20, 4), dtype=torch.float32, device=dev)}
        gm.gather_rows(rows)
        gather_ms = []
        for _ in range(10):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gm.gather_rows(rows)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - t1) * 1e3)
        print(f"NCCL world of one (init {init_s:.3f} s): render_accumulate_multihost {cfg.width}x{cfg.height}@"
              f"{cfg.spp}spp in {mh_s:.3f} s, K1 launches {launches} (expected {sweeps_per_sample(cfg) * cfg.spp}), "
              f"equal to render_accumulate_sharded bit for bit {same}; gather of one 2^20-lane chunk (16.8 MB) "
              f"{statistics.median(gather_ms):.4f} ms (host clock, median of 10) on {kind} [{card}]", flush=True)
        if not same or launches != sweeps_per_sample(cfg) * cfg.spp:
            fail("the NCCL multihost render differs from the sharded render, or did not launch K1 per sweep")
        png = os.path.join(kernels.BUILD_DIR, "chip_smoke_multihost.png")
        want_png = os.path.join(kernels.BUILD_DIR, "chip_smoke_multihost_want.png")
        save_image(want_png, finalize_srgb(cfg, tables, v_mh, a_mh))
        argv = ["-s", cfg.scene, "-w", str(cfg.width), "-h", str(cfg.height), "-spp", str(cfg.spp), "--mode", cfg.mode,
                "--max-depth", str(cfg.max_depth), "--quiet", "-o", png, "--coordinator", f"localhost:{port}",
                "--num-processes", "1", "--process-id", "0"]
        t0 = time.time()
        rc_cli = cli_main(argv)
        cli_s = time.time() - t0
        same_png = False
        if rc_cli == 0:
            with open(png, "rb") as got, open(want_png, "rb") as want:
                same_png = got.read() == want.read()
        print(f"cli {' '.join(argv)}: rc {rc_cli} in {cli_s:.3f} s; its image equal to the multihost render's "
              f"{same_png}")
        if not same_png:
            fail("the CLI's multi-process render failed or wrote another image")
    finally:
        dist.destroy_process_group()

    # the CLI's --sharded with --checkpoint, resumed: bitwise
    pc = cfg.replace(spp=PROGRESSIVE_SPP)

    def renderer(**kw):
        return ProgressiveRenderer(pc, scene, tables, seed=0, spp_per_pass=PROGRESSIVE_PASS_SPP, mesh=mesh,
                                   native=True, **kw)

    whole = renderer()
    whole.run()
    ckpt = os.path.join(kernels.BUILD_DIR, "chip_smoke_sharded.ckpt")
    for path in (ckpt, ckpt + ".meta.json"):
        if os.path.exists(path):
            os.remove(path)
    first = renderer(checkpoint_path=ckpt)
    first.run_pass()
    first.save_checkpoint()
    argv = ["-s", pc.scene, "-w", str(pc.width), "-h", str(pc.height), "-spp", str(pc.spp), "--mode", pc.mode,
            "--max-depth", str(pc.max_depth), "--pass-spp", str(PROGRESSIVE_PASS_SPP), "--sharded", "--checkpoint",
            ckpt, "--quiet", "-o", os.path.join(kernels.BUILD_DIR, "chip_smoke_sharded.png")]
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    cli_s = time.time() - t0
    from_cli = renderer(checkpoint_path=ckpt)
    same = (rc == 0 and f"at {PROGRESSIVE_PASS_SPP} spp" in err.getvalue() and from_cli.resume()
            and from_cli.spp_done == pc.spp
            and all(np.array_equal(a, b) for a, b in zip(from_cli.mean_value(), whole.mean_value())))
    print(f"cli {' '.join(argv)}: rc {rc} in {cli_s:.3f} s, resumed after pass 1; its checkpoint's mean equal to the "
          f"uninterrupted sharded render's bit for bit {same}")
    if not same:
        fail("the CLI's --sharded render did not resume, or its mean differs from the uninterrupted one")
    print(f"phase 16 (parallel) took {time.time() - t_phase:.1f} s", flush=True)
    return by_path, held


def scaling_phase(torch, np, scene, cfg, k1, k2, kind, card):
    """Phase 17: the scaling bench on this run's cards.  Returns K1's
    launches on each of its runs and its twin check at a shard's shape."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.tools import WARMUP_CALLS
    from simple_spectral_torch.tools import scaling_bench as sb

    t_phase = time.time()
    by_path = {}
    runs = {"equal-work": ["--equal-work", "--repeat", str(SCALING_REPEAT)], "weak": []}
    for name, extra in runs.items():
        out = os.path.join(kernels.BUILD_DIR, f"chip_smoke_scaling_{name}.json")
        argv = [out, "--lanes-per-dev", str(SCALING_LANES), "--spp", str(SCALING_SPP), *extra]
        k1.LAUNCHES = k2.LAUNCHES = 0
        rc = sb.main(argv)
        launches, k2_launches = k1.LAUNCHES, k2.LAUNCHES
        if rc != 0:
            fail(f"scaling_bench {' '.join(argv)} exited {rc}")
        with open(out) as f:
            got = json.load(f)
        print(json.dumps(got))
        rows = got["results"]
        want = [sweeps_per_sample(cfg) * SCALING_SPP * r["devices"] for r in rows]
        calls = WARMUP_CALLS + sb.K_CALLS
        print(f"scaling bench {name} ({' '.join(argv[1:])}): K1 launches per call "
              f"{[r['k1_launches_per_call'] for r in rows]} (expected {want}), in all {launches} (expected "
              f"{calls * sum(want)}), K2 {k2_launches}; rates {[r['mrays_per_s'] for r in rows]} Mrays/s "
              f"on {kind} [{card}]", flush=True)
        if set(got) != SCALING_JAX_KEYS[name] or got["backend"] != "cuda" or got["device"] != card:
            fail(f"the scaling bench's {name} JSON has keys {sorted(got)}, backend {got['backend']}")
        if [r["k1_launches_per_call"] for r in rows] != want or launches != calls * sum(want) or k2_launches:
            fail(f"the scaling bench's {name} run launched K1 {launches} times and K2 {k2_launches}")
        by_path[f"scaling bench {name} 512^2 {SCALING_LANES} lanes per device at {SCALING_SPP} spp, devices "
                f"{[r['devices'] for r in rows]} (phase 17)"] = launches
    # K1 against its twin at a shard's shape: the scene's triangles and
    # 65536 random, camera and bounce rays, both key widths
    held = 0
    for exact in (False, True):
        for set_name, (o, d, ign) in ray_sets(torch, np, scene, cfg, SCALING_LANES).items():
            for use_ignore in (False, True):
                ig = ign if use_ignore else torch.full_like(ign, -1)
                label = f"{set_name}, ignore {'on' if use_ignore else 'off'}, scaling shard"
                held = max(held, hold_k1(torch, k1, label, scene.tri_verts, scene.tri_prim, o, d, ig, scene.n_tris,
                                         cfg.eps, exact))
    print(f"phase 17 (scaling bench) took {time.time() - t_phase:.1f} s", flush=True)
    return by_path, {"T": scene.n_tris, "N": SCALING_LANES, "max_abs_err": held}


def run_tool(k1, k2, phase, name, tool, argv, keys, rows_key, expect, launch_keys, kind, card):
    """One measurement tool's run through its entry point, its file under
    _build/.  ``expect(rows)`` gives [(K1, K2) launches per call or per
    render] of its rows and (K1, K2) launches in the whole run;
    ``launch_keys(row)`` names a row's launch columns.  Fails on a non-zero
    exit, an error row, other keys or device, or other launches.  Returns
    (its path's name, (K1, K2) launches in the run, its rows)."""
    from simple_spectral_torch import kernels

    out = os.path.join(kernels.BUILD_DIR, f"chip_smoke_{name}.json")
    if os.path.exists(out):
        os.remove(out)  # cfg5 would merge into it
    k1.LAUNCHES = k2.LAUNCHES = 0
    t0 = time.time()
    rc = tool.main([out, *argv])
    launches = (k1.LAUNCHES, k2.LAUNCHES)
    took = time.time() - t0
    with open(out) as f:
        got = json.load(f)
    print(json.dumps(got))
    rows = got[rows_key]
    errors = [(k, v) for r in rows for k, v in r.items() if k.endswith("error")]
    if rc != 0 or errors:
        fail(f"{name} {' '.join(argv)} exited {rc} with error rows {errors}")
    want, total = expect(rows)
    seen = [(r[k1_key], r[k2_key]) for r in rows for k1_key, k2_key in launch_keys(r)]
    print(f"{name} {' '.join(argv)}: rc {rc} in {took:.1f} s; K1, K2 launches per call {seen} (expected "
          f"{want}), in all {launches} (expected {total}) on {kind} [{card}]", flush=True)
    if set(got) != keys or got["device"] != card:
        fail(f"{name}'s JSON has keys {sorted(got)} and device {got['device']!r}")
    if seen != want or launches != total:
        fail(f"{name} launched K1 and K2 {seen} times per call and {launches} in all")
    return f"{name} {' '.join(argv)} (phase {phase})", launches, rows


def k2_at_scale(torch, np, k2, scene, cfg, what, reps):
    """K2 against its twin on one large scene: the path's sorted bounce
    rays at 262144 lanes, and 4096 random and camera rays in both orders;
    then K2's time (card alone, ``reps`` launches) on the bounce rays beside
    its bound.  Returns the record of the check."""
    from simple_spectral_torch.tools import cuda_time_ms

    lanes = WIDTH * HEIGHT
    dev = scene.device
    err_max = 0
    sets = ray_sets(torch, np, scene, cfg, lanes)
    for set_name, (o, d, ign) in sets.items():
        for n, sort in ((lanes, True),) if set_name == "bounce" else ((4096, False), (4096, True)):
            counts, lists, entries, rays = k2_inputs(torch, k2, scene, o, d, ign, n, sort, cfg.eps)
            got = k2.cull_best(scene.cull_tiles, counts, lists, entries, rays, n, cfg.eps)
            want = k2.cull_best_plain(scene.cull_tiles, counts, lists, rays, cfg.eps)
            err = int((got[:, :n].to(torch.int64) - want[:, :n].to(torch.int64)).abs().max())
            print(f"K2 vs twin at {what}: {set_name:7s} N={n:6d} {'sorted  ' if sort else 'unsorted'} "
                  f"hits={int((got[0, :n] < k2.INF_BITS).sum()):6d} max|diff|={err}", flush=True)
            if err != 0:
                fail(f"K2 disagrees with its twin at {what} on {set_name} rays, N={n}, sorted={sort}")
            err_max = max(err_max, err)
    o, d, ign = sets["bounce"]
    counts, lists, entries, rays = k2_inputs(torch, k2, scene, o, d, ign, lanes, True, cfg.eps)
    tiles = scene.cull_tiles
    visits = torch.zeros((3, counts.shape[0]), dtype=torch.int32, device=dev)
    k2.cull_best_cuda(tiles, counts, lists, entries, rays, lanes, cfg.eps, visits=visits)
    ms = cuda_time_ms(lambda: k2.cull_best_cuda(tiles, counts, lists, entries, rays, lanes, cfg.eps), reps=reps)
    bound, bound_by, text = k2_bound(torch, k2, tiles, counts, lists, entries, rays, lanes, cfg.eps, visits)
    print(f"K2 at N={lanes}, C={tiles.shape[0]} ({what}), sorted bounce rays: {ms:.4f} ms (card alone, {reps} "
          f"launches), bound {bound:.4f} ms ({bound_by}; {text})", flush=True)
    return {"T": scene.n_tris, "spheres": scene.n_spheres, "N": lanes, "max_abs_err": err_max, "ms": ms,
            "bound_ms": bound}


def tools_phase(torch, np, s_scene, s_cfg, k1, k2, kind, card):
    """Phase 18: the four render measurement tools through their entry
    points at reduced sizes, each row's K1 and K2 launches per call held to
    its path's sweeps; then K1 against its twin at the stress tool's dense
    shapes (10,038 and 50,038 triangles, 262144 rays) and K2 at its 10000
    boxes, with their times.  Returns K1's and K2's launches by path and
    their twin checks."""
    from simple_spectral_torch.render.vec import V3
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables
    from simple_spectral_torch.tools import (OPS_PER_TRIANGLE_TEST, WARMUP_CALLS, bound_ms, cfg5, cuda_time_ms,
                                             perf_ablate, perf_modes, stress_render)

    t_phase = time.time()
    k1_paths, k2_paths = {}, {}
    calls = WARMUP_CALLS + TOOLS_CALLS

    def run(name, tool, argv, keys, rows_key, expect):
        path, launches, rows = run_tool(k1, k2, 18, name, tool, argv, keys, rows_key, expect, launch_keys, kind, card)
        k1_paths[path], k2_paths[path] = launches
        return rows

    def launch_keys(row):
        if "k1_launches_per_call" in row:
            return [("k1_launches_per_call", "k2_launches_per_call")]
        if "k1_launches" in row:
            return [("k1_launches", "k2_launches")]
        return [(f"{a}_k1_launches_per_call", f"{a}_k2_launches_per_call") for a in stress_render.ARMS
                if f"{a}_ms" in row]

    def per_call(rows_cfgs):
        want = [(sweeps_per_sample(c), 0) for c in rows_cfgs]
        return want, (calls * sum(w for w, _ in want), 0)

    fwd = perf_ablate.rows({"fwd"})
    run("perf_ablate", perf_ablate, ["fwd", "--calls", str(TOOLS_CALLS)], {"device", "lanes", "results"},
        "results", lambda rows: per_call([r.cfg for r in fwd]))
    cfg0 = stress_render.stress_config(TOOLS_STRESS_BOXES)
    n = sweeps_per_sample(cfg0)
    run("stress_render", stress_render, ["--boxes", str(TOOLS_STRESS_BOXES), "--calls", str(TOOLS_CALLS)],
        {"device", "results"}, "results", lambda rows: ([(0, n), (n, 0)], (calls * n, calls * n)))
    mode, spp = TOOLS_CFG5
    n = sweeps_per_sample(cfg5.card_config(mode)) * spp  # a render's, per chunk
    run("cfg5", cfg5, ["card", "--modes", mode, "--spp", str(spp)], {"configs", "device"}, "configs",
        lambda rows: ([(n * rows[0]["n_chunks"], 0)], (n * rows[0]["n_chunks"], 0)))
    modes = [(c, s) for _, c, _ in perf_modes.rows("cfg3") for s in perf_modes.steps()]
    run("perf_modes", perf_modes, ["cfg3", "--calls", str(TOOLS_CALLS)], {"device", "lanes", "results"}, "results",
        lambda rows: per_call([c for c, _ in modes]))

    # K1 against its twin at the dense arm's shapes: 262144 random, camera
    # and bounce rays over the tool's 1000-box scene and phase 7's 5000-box
    # scene (its triangles are the tool's), exact key, ignore on
    dev = s_scene.device
    d_cfg = stress_render.stress_config(TOOLS_STRESS_BOXES)
    dense = build_scene(d_cfg, build_color_tables(d_cfg, device=dev), device=dev)
    lanes = stress_render.LANES
    k1_held = {}
    for scene, cfg, chunk in ((dense, d_cfg, 8192), (s_scene, s_cfg, 2048)):
        sets = ray_sets(torch, np, scene, cfg, lanes)
        held = 0
        for set_name, (o, d, ign) in sets.items():
            held = max(held, hold_k1(torch, k1, f"{set_name}, stress", scene.tri_verts, scene.tri_prim, o, d, ign,
                                     scene.n_tris, cfg.eps, True, chunk=chunk))
        bo, bd, bign = sets["bounce"]
        o, d = V3(*(c.contiguous() for c in bo)), V3(*(c.contiguous() for c in bd))
        ms = cuda_time_ms(lambda: k1.intersect_best_key(scene.tri_verts, scene.tri_prim, o, d, bign, cfg.eps, True),
                          reps=10)
        t = scene.n_tris
        bound, bound_by, _, _ = bound_ms(lanes * t * OPS_PER_TRIANGLE_TEST, lanes * (6 * 4 + 4 + 8) + t * (9 * 4 + 4))
        print(f"K1 at N={lanes}, T={t} (stress, {cfg.stress_boxes} boxes), bounce rays, exact key: {ms:.4f} ms "
              f"(card alone, 10 launches), bound {bound:.4f} ms ({bound_by})", flush=True)
        k1_held[f"stress {cfg.stress_boxes} boxes, dense arm (phase 18)"] = {
            "T": t, "N": lanes, "max_abs_err": held, "ms": ms, "bound_ms": bound}

    # K2 against its twin at the scale arm's largest scene, 10000 boxes
    # (100,038 triangles, 500 spheres): the path's sorted bounce rays at
    # 262144 lanes, and 4096 random and camera rays in both orders
    b_cfg = stress_render.stress_config(10000)
    t0 = time.time()
    big = build_scene(b_cfg, build_color_tables(b_cfg, device=dev), device=dev)
    print(f"cornell-stress at 10000 boxes built in {time.time() - t0:.2f} s: {big.n_tris} triangles, "
          f"{big.n_spheres} spheres, {big.cull_tiles.shape[0]} clusters", flush=True)
    k2_held = {"stress 10000 boxes, scale arm (phase 18)": k2_at_scale(torch, np, k2, big, b_cfg, "10000 boxes", 20)}
    print(f"phase 18 (measurement tools) took {time.time() - t_phase:.1f} s", flush=True)
    return k1_paths, k2_paths, k1_held, k2_held


def intersect_phase(torch, np, s_cfg, k1, k2, kind, card):
    """Phase 19: the four intersection benches through their entry points at
    reduced sizes, each row's K1 and K2 launches per call held to its
    path's sweeps and cull_micro's parity (K2's route against K1's) passed;
    then K2 against its twin at cluster sizes L = 31 and 15 on phase 7's
    scene rebuilt, with its times and bounds.  Returns K1's and K2's
    launches by path and K2's twin checks."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables
    from simple_spectral_torch.tools import WARMUP_CALLS, bvh_micro, cull_cluster, cull_micro, intersect_micro

    t_phase = time.time()
    k1_paths, k2_paths = {}, {}
    calls = WARMUP_CALLS + INTERSECT_CALLS
    cut = ["--calls", str(INTERSECT_CALLS)]

    def run(name, tool, argv, keys, expect, launch_keys):
        path, launches, rows = run_tool(k1, k2, 19, name, tool, [*argv, *cut], keys, "results", expect, launch_keys,
                                        kind, card)
        k1_paths[path], k2_paths[path] = launches
        return rows

    def own_keys(row):
        return [("k1_launches_per_call", "k2_launches_per_call")]

    def arm_keys(arms):
        return lambda row: [(f"{a}_k1_launches_per_call", f"{a}_k2_launches_per_call") for a in arms
                            if f"{a}_ms" in row]

    # the cull micro-bench: per ray set, the parity check (one K2 and one K1
    # launch), then each arm's calls, one sweep each
    sets_arms = [(t, a) for t in cull_micro.SETS for a in cull_micro.ARMS]

    def cull_micro_launches(rows):
        want = [(int(a == "xla"), int(a == "cull")) for r in rows for t in cull_micro.SETS
                for a in cull_micro.arms(r["tris"])]
        n_sets = len(rows) * len(cull_micro.SETS)
        return want, (n_sets + calls * sum(w for w, _ in want), n_sets + calls * sum(w for _, w in want))

    rows = run("cull_micro", cull_micro, ["--boxes", str(INTERSECT_BOXES)], {"device", "rays", "results"},
               cull_micro_launches, arm_keys([f"{a}_{t}" for t, a in sets_arms]))
    if any(r[f"parity_{t}"]["parity"] != "ok" for r in rows for t in cull_micro.SETS):
        fail(f"cull_micro's parity failed: {rows}")
    n = sweeps_per_sample(cull_cluster.cluster_config(63, INTERSECT_BOXES).replace(max_depth=INTERSECT_DEPTH))
    sizes = ",".join(map(str, INTERSECT_CLUSTER_SIZES))
    rows = run("cull_cluster", cull_cluster, ["--boxes", str(INTERSECT_BOXES), "--sizes", sizes, "--max-depth",
                                              str(INTERSECT_DEPTH)], {"device", "results"},
               lambda rows: ([(0, n)] * len(rows), (0, calls * n * len(rows))), own_keys)
    if [r["cluster_size"] for r in rows] != list(INTERSECT_CLUSTER_SIZES) or \
            rows[0]["clusters"] >= rows[-1]["clusters"]:
        fail(f"cull_cluster's rows are not its cluster sizes with more clusters at smaller sizes: {rows}")
    variants = list(intersect_micro.variants(None, None, None))
    rows = run("intersect_micro", intersect_micro, [], {"device", "rays", "results"},
               lambda rows: ([(1, 0)] * len(variants), (calls * len(variants), 0)), own_keys)
    if [r["variant"] for r in rows] != variants:
        fail(f"intersect_micro's variants are {[r['variant'] for r in rows]}")

    def bvh_launches(rows):
        want = [(int(a == "xla"), 0) for r in rows for a in bvh_micro.arms(r["tris"], r["spheres"])]
        return want, (calls * sum(w for w, _ in want), 0)

    run("bvh_micro", bvh_micro, ["--boxes", ",".join(map(str, INTERSECT_BVH_BOXES))], {"device", "note", "results"},
        bvh_launches, arm_keys(bvh_micro.ARMS))

    # K2 against its twin at the cluster sizes the card had not run: phase
    # 7's scene (5000 boxes, 250 spheres) with its clusters rebuilt at L
    dev = torch.device("cuda")
    k2_held = {}
    for size in K2_NEW_CLUSTER_SIZES:
        cfg = s_cfg.replace(cull_cluster_size=size)
        t0 = time.time()
        scene = build_scene(cfg, build_color_tables(cfg, device=dev), device=dev)
        print(f"cornell-stress at {cfg.stress_boxes} boxes, L = {size}, built in {time.time() - t0:.2f} s: "
              f"{scene.cull_tiles.shape[0]} clusters of tiles {tuple(scene.cull_tiles.shape[1:])}", flush=True)
        what = f"{cfg.stress_boxes} boxes, L = {size}"
        k2_held[f"stress {what}, scale arm (phase 19)"] = {
            "L": size, "clusters": scene.cull_tiles.shape[0], **k2_at_scale(torch, np, k2, scene, cfg, what, 20)}
    print(f"phase 19 (intersection benches) took {time.time() - t_phase:.1f} s", flush=True)
    return k1_paths, k2_paths, k2_held


def stage_phase(torch, np, k1, k2, kind, card):
    """Phase 20: the seven stage and host benches through their entry
    points at reduced sizes.  diag_cfg1's and bwd_bisect's rows launch K1
    as many times per call as their path sweeps (once and four times a
    sample's sweeps) and K2 never; the four gather benches launch neither.
    The texel check runs on the card and on the CPU, and their figures agree
    within ``texel_q32_check.bounds``.  Returns K1's and K2's launches by
    path."""
    from simple_spectral_torch import kernels
    from simple_spectral_torch.spectra.colorimetry import build_color_tables
    from simple_spectral_torch.tools import (WARMUP_CALLS, bwd_bisect, ctx_gather, diag_cfg1, gather_micro,
                                             pack_micro, texel_q32_check, texture_micro)

    t_phase = time.time()
    k1_paths, k2_paths = {}, {}

    def run(name, tool, argv, keys, expect):
        def launch_keys(row):
            return [("k1_launches_per_call", "k2_launches_per_call")] if "k1_launches_per_call" in row else []

        path, launches, rows = run_tool(k1, k2, 20, name, tool, argv, keys, "results", expect, launch_keys, kind,
                                        card)
        k1_paths[path], k2_paths[path] = launches
        return rows

    def per_call(sweeps, calls):
        return lambda rows: ([(sweeps, 0)] * sum("k1_launches_per_call" in r for r in rows),
                             (calls * sweeps * sum("k1_launches_per_call" in r for r in rows), 0))

    depth = ["--max-depth", str(STAGE_DEPTH)]
    n = sweeps_per_sample(diag_cfg1.configs()["mallett cornell-srgb"].replace(max_depth=STAGE_DEPTH))
    rows = run("diag_cfg1", diag_cfg1, ["--lanes", str(STAGE_LANES), *depth, "--calls", "1"],
               {"device", "results", "fixed_ms"}, per_call(n, WARMUP_CALLS + 1))
    if [r["label"] for r in rows] != [diag_cfg1.FOLD_LABEL] + [t[0] for t in diag_cfg1.table((STAGE_LANES,))]:
        fail(f"diag_cfg1's rows are {[r['label'] for r in rows]}")
    rows = run("bwd_bisect", bwd_bisect, ["--size", str(STAGE_SIZE), *depth, "--calls", "1"],
               {"device", "spp", "results"}, per_call(bwd_bisect.SPP * n, WARMUP_CALLS + 1))
    if [r["label"] for r in rows] != [r.label for r in bwd_bisect.ROWS]:
        fail(f"bwd_bisect's rows are {[r['label'] for r in rows]}")
    gather = ["--n", str(STAGE_N), "--calls", str(STAGE_CALLS)]
    for name, tool, keys in (("texture_micro", texture_micro, {"device", "results"}),
                             ("pack_micro", pack_micro, {"device", "n_indices", "table_rows", "results"}),
                             ("gather_micro", gather_micro, {"device", "results"}),
                             ("ctx_gather", ctx_gather, {"device", "results"})):
        run(name, tool, gather, keys, per_call(0, 0))

    # the texel check on the card and on the CPU
    figs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(kernels.BUILD_DIR, f"chip_smoke_texel_q32_{dev}.json")
        t0 = time.time()
        rc = texel_q32_check.main([out, "--crop", str(STAGE_CROP), "--device", dev])
        with open(out) as f:
            figs[dev] = json.load(f)
        print(f"texel_q32_check --crop {STAGE_CROP} --device {dev}: rc {rc} in {time.time() - t0:.1f} s", flush=True)
        if rc != 0 or figs[dev]["device"] != (card if dev == "cuda" else "cpu"):
            fail(f"texel_q32_check on {dev} exited {rc} on device {figs[dev]['device']!r}")
    cfg = texel_q32_check.config()
    img = texel_q32_check.load_texture(cfg, STAGE_CROP)
    packs = {dev: texel_q32_check.pack(img, build_color_tables(cfg, device=dev).jakob, dev) for dev in ("cuda", "cpu")}
    moved = int((packs["cuda"][3] != packs["cpu"][3]).sum())
    tables = build_color_tables(cfg, device="cpu")
    bounds = texel_q32_check.bounds(tables, packs["cpu"][4], moved, STAGE_CROP * STAGE_CROP, STAGE_DECODE_ATOL)
    apart = {(fig, k): abs(figs["cuda"][fig][k] - figs["cpu"][fig][k]) for fig in bounds for k in bounds[fig]}
    print(f"texel_q32_check card against CPU at {STAGE_CROP}x{STAGE_CROP}: {moved} q32 words moved; "
          f"figures apart {apart} within {bounds}", flush=True)
    if any(apart[fig, k] > bounds[fig][k] for fig, k in apart):
        fail(f"texel_q32_check's figures on the card and the CPU lie apart by {apart}, beyond {bounds}")
    print(f"phase 20 (stage and host benches) took {time.time() - t_phase:.1f} s", flush=True)
    return k1_paths, k2_paths


def jakob_fit_phase(torch, np, kind, card):
    """Phase 21: the Jakob-Hanika coefficient fit on the card in float64
    at JAKOB_FIT_RES (the shipped table's width) and JAKOB_CHECK_RES, each
    held against the shipped table under ``fit_jakob_coeffs.misses``; the
    card's table through the cube fetch and the sigmoid beside the shipped
    one; its ``.coeff`` export."""
    import struct
    import tempfile

    from simple_spectral_torch import kernels
    from simple_spectral_torch.spectra.colorimetry import srgb_to_lrgb_np
    from simple_spectral_torch.spectra.spectrum import data_path
    from simple_spectral_torch.spectra.upsample_jakob import (jakob_tables_from_arrays, rgb2spec_eval_soa,
                                                              rgb2spec_fetch_soa)
    from simple_spectral_torch.tools import H100_FP64_OPS_PER_S, export_jakob_coeff
    from simple_spectral_torch.tools import fit_jakob_coeffs as fj

    t_phase = time.time()
    tables = {}
    for res in (JAKOB_FIT_RES, JAKOB_CHECK_RES):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        f = fj.fit(res, "cuda")
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        slice_ms = sum(f.seconds) / (3 * res) * 1e3
        print(f"jakob fit, res {res}, float64 on {kind} [{card}]: {dt:.3f} s, components "
              f"{[round(t, 3) for t in f.seconds]} s, {slice_ms:.3f} ms per slice, max fit rgb error "
              f"{f.max_err:.6e}, peak device memory {peak} bytes; FP64 bound "
              f"{fj.fit_ops(res) / H100_FP64_OPS_PER_S * 1e3:.3f} ms ({fj.fit_ops(res)} operations)", flush=True)
        if res == JAKOB_FIT_RES:
            launches, busy_ms = fj.fit_launches(res, "cuda")
            print(f"  launches {launches}, device busy {busy_ms} ms per slice of {slice_ms:.3f} ms "
                  f"(torch.profiler, fit_launches)", flush=True)
        with np.load(data_path(f"jakob2019-srgb-{res}.npz")) as z:
            shipped = (z["scale"], z["coeffs"])
        cmp = fj.compare_tables((f.scale, f.coeffs), shipped)
        print(f"  against the shipped jakob2019-srgb-{res}.npz: {json.dumps(cmp)}", flush=True)
        missed = fj.misses(cmp, fj.EXCESS_MAX_CARD)
        if missed:
            fail(f"the card's res-{res} jakob table does not hold against the shipped one: {missed}")
        tables[res] = ((f.scale, f.coeffs), shipped)

    # the card's table and the shipped one through the render's fetch and
    # sigmoid: random colours, and the colours of the texels that moved,
    # whose dark slices random colours rarely reach
    card_table, shipped = tables[JAKOB_FIT_RES]
    jaks = [jakob_tables_from_arrays(*t, device="cuda") for t in (card_table, shipped)]

    def apart(what, rgb):
        r, g, b = (torch.as_tensor(np.ascontiguousarray(rgb[:, i]), dtype=torch.float32, device="cuda")
                   for i in range(3))
        lams = torch.linspace(380.0, 780.0, 81, device="cuda")[:, None].expand(81, rgb.shape[0])
        card_sp, shipped_sp = (rgb2spec_eval_soa(*rgb2spec_fetch_soa(jak, r, g, b), lams) for jak in jaks)
        for sp in (card_sp, shipped_sp):
            if not bool(torch.isfinite(sp).all()) or float(sp.min()) < 0.0 or float(sp.max()) > 1.0:
                fail(f"{what}: spectra not finite in [0, 1]: [{float(sp.min())}, {float(sp.max())}]")
        d = (card_sp - shipped_sp).abs()
        print(f"{what}, 81 wavelengths: reflectance on the card's table against the shipped one, max |diff| "
              f"{float(d.max()):.6e}, median {float(d.median()):.6e}", flush=True)

    rng = np.random.default_rng(JAKOB_SEED)
    apart(f"{JAKOB_COLOURS} random sRGB colours", srgb_to_lrgb_np(rng.random((JAKOB_COLOURS, 3))))
    res = JAKOB_FIT_RES
    comp, zi, yi, xi = np.nonzero((card_table[1] != shipped[1]).any(axis=-1))
    z = shipped[0][zi].astype(np.float64)
    rgb = np.zeros((comp.size, 3))
    for k, v in ((0, z), (1, xi / (res - 1) * z), (2, yi / (res - 1) * z)):
        rgb[np.arange(comp.size), (comp + k) % 3] = v
    apart(f"the {comp.size} moved texels' own colours", rgb)

    # the .coeff export of the card's table
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        src = os.path.join(tmp, f"jakob-card-{res}.npz")
        np.savez_compressed(src, scale=card_table[0], coeffs=card_table[1])
        dst = export_jakob_coeff.export(src, os.path.join(tmp, f"jakob-card-{res}.coeff"))
        with open(dst, "rb") as fh:
            head = fh.read(8)
        size = os.path.getsize(dst)
    want = 8 + 4 * res + 4 * 3 * res ** 3 * 3
    print(f"export: {head[:4]!r}, res {struct.unpack('<I', head[4:])[0]}, {size} bytes (expected {want})")
    if head[:4] != b"SPEC" or struct.unpack("<I", head[4:])[0] != res or size != want:
        fail(f"the .coeff export's header {head!r} or size {size} is wrong (expected {want} bytes)")
    print(f"phase 21 (jakob coefficient fit) took {time.time() - t_phase:.1f} s", flush=True)


def threefry_phase(torch, np, scene, tables, cfg):
    """Phase 22: T1 against its int64 twins at T1_SIZES in each epilogue,
    bit for bit under two keys; its card-alone time beside its bound and
    the twin's times; then one main-path train step with every draw
    counted against T1's launches.  Returns T1's kernel record."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.render.trainstep import forward_backward_step
    from simple_spectral_torch.tools import cuda_time_ms, host_inclusive_ms

    t_phase = time.time()
    dev = scene.device
    keys = (rnd.PRNGKey(0), rnd.fold_in(rnd.PRNGKey(2**31 + 5), 17))

    def draws(kind, bounds):
        if kind == "bits":
            return (lambda k, n: rnd.random_bits(k, (n,), dev)), (lambda k, n: rnd.random_bits_plain(k, (n,), dev))
        if kind == "uniform":
            return (lambda k, n: rnd.uniform(k, (n,), dev)), (lambda k, n: rnd.uniform_plain(k, (n,), dev))
        return ((lambda k, n: rnd.randint(k, (n,), *bounds, dev)),
                (lambda k, n: rnd.randint_plain(k, (n,), *bounds, dev)))

    main = None
    for n in T1_SIZES:
        for kind, bounds in T1_DRAWS:
            kernel, plain = draws(kind, bounds)
            for key in keys:
                before = rnd.LAUNCHES
                got, want = kernel(key, n), plain(key, n)
                torch.cuda.synchronize()
                launches = rnd.LAUNCHES - before
                if got.dtype == torch.float32:
                    got, want = got.view(torch.int32), want.view(torch.int32)
                if launches != 1 or got.dtype != want.dtype or not torch.equal(got, want):
                    fail(f"T1 {kind} {bounds or ''} at n={n}: {launches} launches (expected 1), "
                         f"{int((got != want).sum())} words apart from the twin")
            key = keys[1]
            ms = cuda_time_ms(lambda: kernel(key, n))
            # two calls: the device's launch queue (about a thousand launches)
            # must take every twin launch of the run behind the spin
            plain_ms = cuda_time_ms(lambda: plain(key, n), reps=2)
            plain_host_ms = host_inclusive_ms(lambda: plain(key, n), 10)
            ops, int_ops = T1_OPS[kind]
            bound, by = max((n * ops / H100_ISSUE_PER_S * 1e3, "instruction issue"),
                            (n * int_ops / H100_INT32_PIPE_PER_S * 1e3, "the INT32 pipe"),
                            (n * T1_BYTES[kind] / 3.35e12 * 1e3, "bytes"))
            print(f"T1 {kind:7s} {str(bounds or ''):24s} n={n:7d}: equal to the twin bit for bit under "
                  f"{len(keys)} keys; kernel {ms:.4f} ms (card alone, 100 launches), bound {bound:.4f} ms "
                  f"({by}; {ms / bound:.2f}x), twin {plain_ms:.4f} ms card alone (2 calls), {plain_host_ms:.4f} ms "
                  f"host-inclusive (median of 10)")
            if kind == "uniform" and n == max(T1_SIZES):
                main = {"ms": ms, "plain_ms": plain_host_ms, "bound_ms": bound, "bound_by": by}

    # the main path's train step: one launch per draw
    n = cfg.width * cfg.height
    px = torch.arange(n, dtype=torch.int32, device=dev)
    target = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    calls = []
    originals = {name: getattr(rnd, name) for name in ("uniform", "random_bits", "randint")}

    def counted(name):
        def draw(*args, **kw):
            calls.append(name)
            return originals[name](*args, **kw)
        return draw

    try:
        for name in originals:
            setattr(rnd, name, counted(name))
        before = rnd.LAUNCHES
        loss, _ = forward_backward_step(scene, tables, cfg, rnd.fold_in(rnd.PRNGKey(0), 0), px, target, 1)
        torch.cuda.synchronize()
        launches = rnd.LAUNCHES - before
    finally:
        for name, fn in originals.items():
            setattr(rnd, name, fn)
    counts = {name: calls.count(name) for name in originals}
    print(f"forward_backward_step {cfg.scene} {n} lanes: T1 launches {launches}, draws {counts}, loss "
          f"{float(loss):.6g}")
    if launches != len(calls) or not torch.isfinite(loss):
        fail(f"the train step launched T1 {launches} times for {len(calls)} draws")
    print(f"phase 22 (threefry) took {time.time() - t_phase:.1f} s", flush=True)
    return {"name": "T1", "route": "cuda", "source": "simple_spectral_torch/csrc/threefry.cu",
            "replaces": "none: jax.random's threefry, left to XLA", "launches": launches, "max_abs_err": 0.0,
            **main, "library_ms": None}


def main() -> int:
    t_start = time.time()
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
    sources = ("intersect_best_key.cu", "cull_best.cu", "bounce_fused.cu", "gather_u32.cu", "threefry.cu")
    if not all(os.path.isfile(os.path.join(csrc, f)) for f in sources):
        print(f"chip_smoke: no simple_spectral_torch package with its sources beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from simple_spectral_torch import kernels
    from simple_spectral_torch import random as rnd
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

    # --- phase 1: build the five kernels from the checkout's sources ---
    t0 = time.time()
    libs = kernels.build(k1.SOURCE, k2.SOURCE, s1.SOURCE, tg.SOURCE, rnd.SOURCE)
    print(f"K1, K2, S1, gather_u32 and T1 built in {time.time() - t0:.2f} s -> "
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

    # --- phases 12 and 13: the meng and jakob pipelines, bench.py's cfg3 and cfg4 ---
    by_path = {"train cornell-srgb mallett (phase 3)": record["launches"]}
    held_by_path = {}
    for phase, name in ((12, "cfg3 cornell-srgb meng 2006 256^2"), (13, "cfg4 plane-srgb jakob 512^2")):
        train, render, held = colour_phase(torch, np, name, k1, k2, kind, card)
        by_path[f"train {name} (phase {phase})"] = train
        by_path[f"render_image {name} at {SPP} spp (phase {phase})"] = render
        held_by_path[f"{name} (phase {phase})"] = held
        record["max_abs_err"] = max(record["max_abs_err"], held["max_abs_err"])
    # --- phase 14: the CLI's own path, progressive passes with checkpoint and resume ---
    by_path[f"progressive cornell-srgb 512^2 at {PROGRESSIVE_SPP} spp (phase 14)"] = progressive_phase(
        torch, np, scene, tables, cfg, k1, k2, kind, card)

    # --- phase 15: the BVH arm against K1 and K2, and a debug-checked chunk ---
    by_path["debug-checked cornell-srgb chunk 64^2 at 1 spp (phase 15)"] = bvh_phase(
        torch, np, s_scene, s_tables, s_cfg, scene, tables, cfg, k1, k2, kind, card)

    # --- phase 16: the parallel path: cfg5 on the 1x1 mesh, the sharded train step, a 4x2 mesh on one card, NCCL ---
    paths, held = parallel_phase(torch, np, scene, tables, cfg, k1, k2, kind, card)
    by_path.update(paths)
    held_by_path["cfg5 cornell-srgb 1024^2 (phase 16a)"] = held
    record["max_abs_err"] = max(record["max_abs_err"], held["max_abs_err"])

    # --- phase 17: the scaling bench, equal work on one card's shards and weak scaling over the cards ---
    paths, held = scaling_phase(torch, np, scene, cfg, k1, k2, kind, card)
    by_path.update(paths)
    held_by_path["scaling bench shard cornell-srgb (phase 17)"] = held
    record["max_abs_err"] = max(record["max_abs_err"], held["max_abs_err"])

    # --- phase 18: the render measurement tools, and K1 and K2 at the stress tool's shapes ---
    k1_paths, k2_paths, k1_held, k2_held = tools_phase(torch, np, s_scene, s_cfg, k1, k2, kind, card)
    by_path.update(k1_paths)
    held_by_path.update(k1_held)
    record["max_abs_err"] = max([record["max_abs_err"]] + [h["max_abs_err"] for h in k1_held.values()])

    # --- phase 19: the intersection benches, and K2 at cluster sizes 31 and 15 ---
    k1_paths19, k2_paths19, k2_held19 = intersect_phase(torch, np, s_cfg, k1, k2, kind, card)
    by_path.update(k1_paths19)

    # --- phase 20: the stage and host benches ---
    k1_paths20, k2_paths20 = stage_phase(torch, np, k1, k2, kind, card)
    by_path.update(k1_paths20)

    # --- phase 21: the jakob coefficient fit on the card, float64 ---
    jakob_fit_phase(torch, np, kind, card)

    # --- phase 22: T1, the threefry draw, against its twins, and its launches in the train step ---
    t1_record = threefry_phase(torch, np, scene, tables, cfg)
    record["launches_by_path"] = by_path
    record["held_by_path"] = held_by_path
    k2_record["launches_by_path"] = {
        f"render_image cornell-stress 512^2 at {STRESS_SPP} spp (phase 8)": k2_record["launches"],
        "progressive cornell-srgb (phase 14)": 0, "bvh render (phase 15)": 0,
        "cfg5 and the sharded train step (phase 16)": 0, "scaling bench (phase 17)": 0, **k2_paths, **k2_paths19,
        **k2_paths20}
    k2_held.update(k2_held19)
    k2_record["held_by_path"] = k2_held
    k2_record["max_abs_err"] = max([k2_record["max_abs_err"]] + [h["max_abs_err"] for h in k2_held.values()])
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f} s (wall, kernel builds included)")

    print(json.dumps({"kernels": [record, k2_record, s1_record, gather_record, t1_record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
