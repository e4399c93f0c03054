"""One fused bounce step on the card: kernel S1 against its eager twin.

    python -m simple_spectral_torch.tools.bench_megakernel [--lanes 262144] [--reps 30]

The port's counterpart of the JAX package's TPU spike
``tools/bench_megakernel.py``, which asked whether one kernel for a whole
bounce beats the same operations run one by one.  The bounce, per lane:

    closest hit over the 38 cornell triangles (watertight shear test)
  + an area sample on the quad light + the shadow closest hit
  + a cosine-hemisphere direction around the hit normal

once as eager torch (:func:`bounce_plain`, the twin of the spike's
``_bounce_jnp`` operation for operation) and once as the CUDA kernel S1
(``csrc/bounce_fused.cu``, :func:`bounce_fused`).  Both read the scene as
the spike's rows (:func:`scene_rows`) and the same precomputed uniforms.

The rows differ from the spike's in one word.  The spike writes the kind of
a triangle row as the int32 1 into its float32 array, where the test
compares it with ``1.0``; stored, that word is the denormal 1.4e-45, so in
the spike no triangle ever passes and every lane misses.  Here the kind is
``1.0f`` (``-1.0f`` on padding), the bounce the spike's docstring
describes.  Primitive ids stay int32 bits in word 11 and are compared as
bits.

The entry point runs the fused bounce on camera rays of cornell at 64x64
(the spike's inputs), fails unless some lane hits, holds the kernel
against the twin (distance and both primitive ids bit for bit; the
direction and n.wi within what sinf, cosf and rsqrtf may give) and prints
the kernel's time, the twin's, the hit count and the kernel's bound.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from simple_spectral_torch import kernels
from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.vec import select3
from simple_spectral_torch.tools import OPS_PER_TRIANGLE_TEST, bound_ms, cuda_time_ms, host_inclusive_ms

N = 262144  # lanes of the spike's bounce
ROWS = 40  # rows of the scene block: 38 triangles and 2 padding rows
SEL = 38  # rows a winner's normal and prim are selected from, as the spike's loop
EPS = 1e-3
INF_BITS = 0x7F800000
TWO_PI = float(np.float32(2.0 * np.pi))
# FP32 operations of one lane outside the two sweeps: light sample 12, the
# shadow direction 3 + its normalisation 10, hit point 6, two axis picks 12,
# the ONB and the direction 36, n.wi 5 (sqrtf, sinf, cosf, rsqrtf as one each)
LANE_OPS = 84
# bytes of one lane: rays f32[8] and uniforms f32[4] in, f32[8] out
LANE_BYTES = (8 + 4 + 8) * 4
# tolerance of the direction and n.wi against the twin on the card
WI_TOL = 1e-6

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("bounce_fused.cu")
# bounce_fused_launch(rows, light, rays, u, out, n, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]


def scene_rows(scene):
    """The cornell scene (38 triangles) as the spike's rows: f32[40, 128]
    (word 0 the kind, 1.0 for a triangle and -1.0 for padding; words 2..10
    the vertices; word 11 the prim id's int32 bits; words 12..14 the normal),
    the light block f32[8, 128] (row 0: a corner of the first light quad and
    its two edges) and the light's prim id.  Tensors on the scene's device."""
    t = scene.tri_verts.cpu().numpy()
    n_t = t.shape[0]
    if n_t != SEL:
        raise ValueError(f"the spike's rows hold cornell's {SEL} triangles, the scene has {n_t}")
    rows = np.zeros((ROWS, 128), np.float32)
    rows_i = rows.view(np.int32)
    rows[:n_t, 2:11] = t.reshape(n_t, 9)
    rows[:n_t, 0] = 1.0
    rows[n_t:, 0] = -1.0
    rows_i[:n_t, 11] = scene.tri_prim.cpu().numpy()
    rows[:n_t, 12:15] = scene.tri_normal.cpu().numpy()
    lt = scene.light_tris.cpu().numpy()[0]
    lv, lv2 = t[lt[0]], t[lt[1]]
    light = np.zeros((8, 128), np.float32)
    light[0, :3] = lv[0]
    light[0, 3:6] = lv[1] - lv[0]  # edge u
    light[0, 6:9] = lv2[2] - lv[0]  # edge v
    dev = scene.device
    return torch.from_numpy(rows).to(dev), torch.from_numpy(light).to(dev), int(scene.light_prims[0])


def _closest(rows, ox, oy, oz, dx, dy, dz, ign_bits):
    """Closest hit over the rows ([ROWS, N] grids): (distance quantized to
    the key, inf on a miss; winning row, 0 on a miss), each [1, N]."""
    aax, aay, aaz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
    x_wins = (aax > aay) & (aax > aaz)
    y_wins = (~x_wins) & (aay > aaz)
    kz = torch.where(x_wins, 0, torch.where(y_wins, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    d_kz = select3(kz, dx, dy, dz)
    neg = d_kz < 0.0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    inv_dz = 1.0 / torch.where(d_kz == 0.0, 1.0, d_kz)
    sx = select3(kx, dx, dy, dz) * inv_dz
    sy = select3(ky, dx, dy, dz) * inv_dz

    def sheared(v):
        rx = rows[:, 2 + 3 * v:3 + 3 * v] - ox
        ry = rows[:, 3 + 3 * v:4 + 3 * v] - oy
        rz = rows[:, 4 + 3 * v:5 + 3 * v] - oz
        r_kx = select3(kx, rx, ry, rz)
        r_ky = select3(ky, rx, ry, rz)
        r_kz = select3(kz, rx, ry, rz)
        return r_kx - sx * r_kz, r_ky - sy * r_kz, r_kz

    ax_a, ay_a, az_a = sheared(0)
    ax_b, ay_b, az_b = sheared(1)
    ax_c, ay_c, az_c = sheared(2)
    uu = ay_b * ax_c - ax_b * ay_c
    vv = ay_c * ax_a - ax_c * ay_a
    ww = ay_a * ax_b - ax_a * ay_b
    inside = ((uu >= 0.0) & (vv >= 0.0) & (ww >= 0.0)) | ((uu <= 0.0) & (vv <= 0.0) & (ww <= 0.0))
    det = uu + vv + ww
    t_scaled = inv_dz * (uu * az_a + vv * az_b + ww * az_c)
    same_sign = (det < 0.0) == (t_scaled < 0.0)
    dist = t_scaled / torch.where(det == 0.0, 1.0, det)
    ok = (inside & (torch.abs(det) > EPS) & same_sign & (dist >= EPS) & (rows[:, 0:1] == 1.0)
          & (rows[:, 11:12].view(torch.int32) != ign_bits))
    cand = torch.where(ok, dist, torch.inf)
    iota = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)[:, None]
    win = ((cand.view(torch.int32) & ~63) | iota).min(dim=0, keepdim=True).values
    wdist = torch.where(win < INF_BITS, (win & ~63).view(torch.float32), torch.inf)
    return wdist, win & 63


def _select(rows, row, word):
    """rows[row, word] where row < SEL, else 0 (the spike's masked loop)."""
    sel = row < SEL
    return torch.where(sel, rows[torch.where(sel, row, 0).to(torch.int64), word], 0.0)


def bounce_plain(rows: torch.Tensor, light: torch.Tensor, rays: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of S1 (the spike's ``_bounce_jnp``, operation for
    operation): rays f32[8, N] (ox oy oz dx dy dz, the ignored prim's bits,
    pad), u f32[4, N] -> f32[8, N] (dist, prim bits, shadow prim bits, wi
    xyz, n.wi, 0)."""
    ox, oy, oz, dx, dy, dz = (rays[k:k + 1] for k in range(6))
    dist, wrow = _closest(rows, ox, oy, oz, dx, dy, dz, rays[6:7].view(torch.int32))
    hit = torch.isfinite(dist)
    sd = torch.where(hit, dist, 0.0)
    hx, hy, hz = ox + sd * dx, oy + sd * dy, oz + sd * dz
    nx, ny, nz = (_select(rows, wrow, w) for w in (12, 13, 14))
    wprim = _select(rows, wrow, 11)

    lw = light[0]
    lx = lw[0] + u[0:1] * lw[3] + u[1:2] * lw[6]
    ly = lw[1] + u[0:1] * lw[4] + u[1:2] * lw[7]
    lz = lw[2] + u[0:1] * lw[5] + u[1:2] * lw[8]
    sx, sy, sz = lx - hx, ly - hy, lz - hz
    sl = torch.rsqrt(sx * sx + sy * sy + sz * sz + 1e-30)
    sx, sy, sz = sx * sl, sy * sl, sz * sl
    _, srow = _closest(rows, hx, hy, hz, sx, sy, sz, wprim.view(torch.int32))
    sprim = _select(rows, srow, 11)

    ang = u[2:3] * TWO_PI
    r2 = u[3:4]
    rad = torch.sqrt(r2)
    yy = torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    bx = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    bz = (b, sign + ny * ny * a, -ny)
    ca, sa = torch.cos(ang), torch.sin(ang)
    wix = rad * ca * bx[0] + yy * nx + rad * sa * bz[0]
    wiy = rad * ca * bx[1] + yy * ny + rad * sa * bz[1]
    wiz = rad * ca * bx[2] + yy * nz + rad * sa * bz[2]
    ndl = wix * nx + wiy * ny + wiz * nz
    return torch.cat([dist, wprim, sprim, wix, wiy, wiz, ndl, torch.zeros_like(dist)])


def bounce_cuda(rows: torch.Tensor, light: torch.Tensor, rays: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch S1 on CUDA tensors; the shapes of :func:`bounce_plain`."""
    global LAUNCHES
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"bounce_cuda needs CUDA tensors, got {dev}")
    n = rays.shape[1]
    for name, x, shape in (("rows", rows, (ROWS, 128)), ("light", light, (8, 128)), ("rays", rays, (8, n)),
                           ("u", u, (4, n))):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous float32{list(shape)} on {dev}, "
                             f"got {x.dtype}{list(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")
    out = torch.empty((8, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch = kernels.load(SOURCE, "bounce_fused_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(rows.data_ptr(), light.data_ptr(), rays.data_ptr(), u.data_ptr(), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"bounce_fused kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def bounce_fused(rows: torch.Tensor, light: torch.Tensor, rays: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One fused bounce: CUDA tensors launch S1, CPU tensors run the twin."""
    if rays.device.type == "cpu":
        return bounce_plain(rows, light, rays, u)
    return bounce_cuda(rows, light, rays, u)


def bounce_inputs(scene, cfg: RenderConfig, n: int, seed: int = 0):
    """The spike's inputs: camera rays through the pixels of ``cfg`` in
    order (wrapping), ignoring nothing, as rays f32[8, n], and uniforms
    f32[4, n], on the scene's device."""
    from simple_spectral_torch.render.integrator import camera_rays_soa

    dev = scene.device
    key = rnd.PRNGKey(seed)
    px = torch.arange(n, dtype=torch.int32, device=dev) % (cfg.width * cfg.height)
    o, d = camera_rays_soa(scene, cfg, key, px % cfg.width, px // cfg.width)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, torch.full_like(d.x, -1.0), torch.zeros_like(d.x)])
    u = rnd.uniform(rnd.fold_in(key, 1), (4, n), dev)
    return rays.contiguous(), u


def run(device="cuda", n: int = N, seed: int = 0):
    """The entry point's path: cornell at 64x64 (rgb), its rows, the
    spike's inputs and one fused bounce.  Returns (rows, light, rays, u,
    out)."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    dev = resolve_device(device)
    cfg = RenderConfig(scene="cornell", mode="rgb", width=64, height=64)
    scene = build_scene(cfg, build_color_tables(cfg, device=dev), device=dev)
    rows, light, _ = scene_rows(scene)
    rays, u = bounce_inputs(scene, cfg, n, seed)
    return rows, light, rays, u, bounce_fused(rows, light, rays, u)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel output against the twin's: lanes whose distance or primitive
    ids differ in any bit, and the largest difference of wi and n.wi."""
    bits_g, bits_w = got[:3].contiguous().view(torch.int32), want[:3].contiguous().view(torch.int32)
    return {
        "dist_prim_bits_differ": int((bits_g != bits_w).any(dim=0).sum()),
        "wi_ndl_max_abs_err": float((got[3:] - want[3:]).abs().max()) if got.shape[1] else 0.0,
    }


def bound(n: int):
    """(ms, bound_by, text) of S1's least time for n lanes."""
    ops = n * (2 * SEL * OPS_PER_TRIANGLE_TEST + LANE_OPS)
    bytes_moved = n * LANE_BYTES + ROWS * 15 * 4 + 9 * 4
    ms, by, ops_ms, bytes_ms = bound_ms(ops, bytes_moved)
    return ms, by, (f"{ops / 1e9:.3f} GFLOP -> {ops_ms:.4f} ms; {bytes_moved / 1e6:.2f} MB -> {bytes_ms:.4f} ms")


def measure(rows, light, rays, u, out, reps: int = 100) -> dict:
    """Hold the fused bounce ``out`` against the twin and, on the card, time
    both: the kernel on the card alone over ``reps`` launches, the twin
    host-inclusive (median of 5).  Returns the kernel's record
    (``launches`` left to the caller)."""
    want = bounce_plain(rows, light, rays, u)
    diff = compare(out, want)
    n = rays.shape[1]
    ms_bound, by, text = bound(n)
    rec = {"name": "bounce_fused", "route": "cuda", "source": "simple_spectral_torch/csrc/bounce_fused.cu",
           "replaces": "tools/bench_megakernel.py:198", "launches": None,
           "max_abs_err": diff["wi_ndl_max_abs_err"], "ms": None, "plain_ms": None, "bound_ms": ms_bound,
           "bound_by": by, "library_ms": None, "hits": int(torch.isfinite(out[0]).sum()),
           "shadow_prims": int(torch.unique(out[2].contiguous().view(torch.int32)).numel()),
           "dist_prim_bits_differ": diff["dist_prim_bits_differ"], "bound_text": text}
    if rays.device.type == "cuda":
        rec["ms"] = cuda_time_ms(lambda: bounce_cuda(rows, light, rays, u), reps)
        rec["plain_ms"] = host_inclusive_ms(lambda: bounce_plain(rows, light, rays, u), 5)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=int, default=N)
    p.add_argument("--reps", type=int, default=100, help="launches timed back to back")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the twin; no times)")
    args = p.parse_args(argv)
    try:
        rows, light, rays, u, out = run(args.device, args.lanes)
    except RuntimeError as e:
        print(f"bench_megakernel: {e}", file=sys.stderr)
        return 1
    rec = measure(rows, light, rays, u, out, args.reps)
    n = args.lanes
    print(f"fused bounce at N={n}: {rec['hits']} lanes hit, {rec['shadow_prims']} distinct shadow prims; "
          f"kernel vs twin: {rec['dist_prim_bits_differ']} lanes with dist/prim bits apart, "
          f"wi/n.wi max |diff| {rec['max_abs_err']:.3e}")
    if rays.device.type == "cuda":
        print(f"kernel {rec['ms']:.4f} ms (card alone, {args.reps} launches), eager twin {rec['plain_ms']:.4f} ms "
              f"(host-inclusive, median of 5), bound {rec['bound_ms']:.4f} ms ({rec['bound_text']})")
    else:
        print(f"on the CPU: the twin ran, times not measured; bound on the card {rec['bound_ms']:.4f} ms")
    print(json.dumps(rec))
    ok = rec["hits"] > 0 and rec["dist_prim_bits_differ"] == 0 and rec["max_abs_err"] <= WI_TOL
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
