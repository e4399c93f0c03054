"""Closest-hit best-key sweep: the wrapper of kernel K1 and its plain twin.

Counterpart of ``simple_spectral_tpu/render/intersect_pallas.py``, whose
Pallas ``_kernel`` this replaces.  The kernel is CUDA C++ for Hopper
(``csrc/intersect_best_key.cu``; its header notes the bound and the design),
built with ``nvcc`` at first use into ``simple_spectral_torch/_build/`` and
loaded with ``ctypes``.  It returns one packed key per ray, in one of two
widths:

    quantized, int32:  (bitcast_i32(dist) & ~idx_mask) | triangle_index,  INF_BITS = miss
    exact, int64:      (bitcast_i32(dist) << 32) | triangle_index,        INF_KEY64 = miss

The quantized key is the Pallas kernel's (ties within the dropped mantissa
bits go to the lower index); the exact key's minimum is the least distance
with exact-equal distances going to the first index, ``jnp.argmin``'s choice
in the JAX package's "xla" sweep.

For tensors on the CPU the wrapper runs :func:`best_key_plain`, the plain
PyTorch twin that computes the same key over a ``[T, N]`` grid; the tests
hold it against the JAX package, and ``chip_smoke.py`` holds the kernel
against it on the card.  A CUDA tensor always goes to the kernel: a missing
``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from simple_spectral_torch import kernels
from simple_spectral_torch.render.vec import V3, select3

INF_BITS = 0x7F800000  # bit pattern of +inf as int32
INF_KEY64 = INF_BITS << 32  # the exact key of a miss
_LOW32 = 0xFFFFFFFF

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("intersect_best_key.cu")
# intersect_best_key_launch(rays, ignore, tris, prim, out, n, t, idx_mask, eps, wide, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def key_idx_mask(n_tris: int) -> int:
    """Low-bit mask holding the triangle index inside a packed key."""
    return (1 << max(1, (n_tris - 1).bit_length())) - 1


def key_parts(key: torch.Tensor, n_tris: int, exact: bool):
    """(hit bool[N], triangle i64[N], distance f32[N]) of best keys; the
    distance is exact for the exact key and the key's quantized prefix
    otherwise, inf where the ray missed."""
    if exact:
        hit = key < INF_KEY64
        tri = key & _LOW32
        dist = (key >> 32).to(torch.int32).view(torch.float32)
    else:
        idx_mask = key_idx_mask(n_tris)
        hit = key < INF_BITS
        tri = (key & idx_mask).to(torch.int64)
        dist = (key & ~idx_mask).view(torch.float32)
    return hit, torch.where(hit, tri, 0), torch.where(hit, dist, torch.inf)


def best_key_cuda(rays: torch.Tensor, ignore: torch.Tensor, tris: torch.Tensor, prim: torch.Tensor,
                  eps: float, exact: bool = False) -> torch.Tensor:
    """Launch K1: rays f32[6, N] (ox oy oz dx dy dz), ignore i32[N], tris
    f32[T, 9] (three vertices), prim i32[T] -> best key i32[N], or i64[N]
    with ``exact``."""
    global LAUNCHES
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"best_key_cuda needs CUDA tensors, got {dev}")
    n, t = rays.shape[1], tris.shape[0]
    for name, x, dtype, shape in (
        ("rays", rays, torch.float32, (6, n)),
        ("ignore", ignore, torch.int32, (n,)),
        ("tris", tris, torch.float32, (t, 9)),
        ("prim", prim, torch.int32, (t,)),
    ):
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype}{list(shape)} on {dev}, "
                f"got {x.dtype}{list(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
            )
    if t < 1 or t > (1 << 23):
        raise ValueError(f"triangle count {t} outside [1, 2^23]")
    out = torch.empty((n,), dtype=torch.int64 if exact else torch.int32, device=dev)
    if n == 0:
        return out
    launch = kernels.load(SOURCE, "intersect_best_key_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            rays.data_ptr(), ignore.data_ptr(), tris.data_ptr(), prim.data_ptr(), out.data_ptr(),
            n, t, key_idx_mask(t), float(np.float32(eps)), int(exact), stream,
        )
    if err != 0:
        raise RuntimeError(f"intersect_best_key kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def best_key_plain(tri_verts: torch.Tensor, tri_prim: torch.Tensor, o: V3, d: V3,
                   ignore_prim: torch.Tensor, eps: float, exact: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of K1: the same key over a [T, N] grid, with the
    same FP32 operations in the same order (``intersect_rays_soa2``'s pass 1
    in the JAX package); i64[N] exact keys with ``exact``."""
    from simple_spectral_torch.render.intersect import _pick_axes

    eps = float(np.float32(eps))
    n_tris = tri_verts.shape[0]
    idx_mask = key_idx_mask(n_tris)
    kx, ky, kz, dz = _pick_axes(d)
    inv_dz = 1.0 / torch.where(dz == 0.0, 1.0, dz)
    sx = select3(kx, d.x, d.y, d.z) * inv_dz
    sy = select3(ky, d.x, d.y, d.z) * inv_dz
    sz = inv_dz
    kxe, kye, kze = kx[None, :], ky[None, :], kz[None, :]

    def sheared(vert):
        rx = tri_verts[:, vert, 0][:, None] - o.x[None, :]
        ry = tri_verts[:, vert, 1][:, None] - o.y[None, :]
        rz = tri_verts[:, vert, 2][:, None] - o.z[None, :]
        r_kx = select3(kxe, rx, ry, rz)
        r_ky = select3(kye, rx, ry, rz)
        r_kz = select3(kze, rx, ry, rz)
        return r_kx - sx[None, :] * r_kz, r_ky - sy[None, :] * r_kz, r_kz

    ax_a, ay_a, az_a = sheared(0)
    ax_b, ay_b, az_b = sheared(1)
    ax_c, ay_c, az_c = sheared(2)
    u = ay_b * ax_c - ax_b * ay_c
    v = ay_c * ax_a - ax_c * ay_a
    w = ay_a * ax_b - ax_a * ay_b
    inside = ((u >= 0.0) & (v >= 0.0) & (w >= 0.0)) | ((u <= 0.0) & (v <= 0.0) & (w <= 0.0))
    det = u + v + w
    t_scaled = sz[None, :] * (u * az_a + v * az_b + w * az_c)
    same_sign = torch.signbit(det) == torch.signbit(t_scaled)
    dist = t_scaled / torch.where(det == 0.0, 1.0, det)
    not_ignored = tri_prim[:, None] != ignore_prim[None, :]
    valid = inside & (torch.abs(det) > eps) & same_sign & (dist >= eps) & not_ignored
    if exact:
        iota_t = torch.arange(n_tris, dtype=torch.int64, device=dist.device)[:, None]
        key = torch.where(valid, (dist.view(torch.int32).to(torch.int64) << 32) | iota_t, INF_KEY64)
    else:
        iota_t = torch.arange(n_tris, dtype=torch.int32, device=dist.device)[:, None]
        key = torch.where(valid, (dist.view(torch.int32) & ~idx_mask) | iota_t, INF_BITS)
    return key.min(dim=0).values


def intersect_best_key(tri_verts: torch.Tensor, tri_prim: torch.Tensor, o: V3, d: V3,
                       ignore_prim: torch.Tensor, eps: float, exact: bool = False) -> torch.Tensor:
    """Closest-hit sweep: rays (V3 o, V3 d, i32[N] ignore) -> best_key
    i32[N] (quantized) or i64[N] (``exact``); :func:`key_parts` unpacks it.
    CUDA tensors launch K1, CPU tensors run the twin."""
    if tri_verts.device.type == "cpu":
        return best_key_plain(tri_verts, tri_prim, o, d, ignore_prim, eps, exact)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
    tris = tri_verts.reshape(tri_verts.shape[0], 9).contiguous()
    return best_key_cuda(rays, ignore_prim.to(torch.int32).contiguous(), tris,
                         tri_prim.to(torch.int32).contiguous(), eps, exact)
