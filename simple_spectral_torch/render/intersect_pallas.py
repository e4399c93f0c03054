"""Closest-hit best-key sweep: the wrapper of kernel K1 and its plain twin.

Counterpart of ``simple_spectral_tpu/render/intersect_pallas.py``, whose
Pallas ``_kernel`` this replaces.  The kernel is CUDA C++ for Hopper
(``csrc/intersect_best_key.cu``; its header notes the bound and the design),
built with ``nvcc`` at first use into ``simple_spectral_torch/_build/`` and
loaded with ``ctypes``.  It returns one packed int32 key per ray:

    key = (bitcast_i32(dist) & ~idx_mask) | triangle_index,  INF_BITS = miss

For tensors on the CPU the wrapper runs :func:`best_key_plain`, the plain
PyTorch twin that computes the same key over a ``[T, N]`` grid; the tests
hold it against the JAX package, and ``chip_smoke.py`` holds the kernel
against it on the card.  A CUDA tensor always goes to the kernel: a missing
``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from simple_spectral_torch.render.vec import V3, select3

INF_BITS = 0x7F800000  # bit pattern of +inf as int32

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = 0

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "intersect_best_key.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_lib = None


def key_idx_mask(n_tris: int) -> int:
    """Low-bit mask holding the triangle index inside a packed key."""
    return (1 << max(1, (n_tris - 1).bit_length())) - 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the K1 kernel is built from source at first use")


def library_path() -> str:
    """Path of the built kernel library, keyed by a hash of the source and
    the flags."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"intersect_best_key-{digest}.so")


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.intersect_best_key_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def best_key_cuda(rays: torch.Tensor, ignore: torch.Tensor, tris: torch.Tensor, prim: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Launch K1: rays f32[6, N] (ox oy oz dx dy dz), ignore i32[N], tris
    f32[T, 9] (three vertices), prim i32[T] -> best key i32[N]."""
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
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.intersect_best_key_launch(
            rays.data_ptr(), ignore.data_ptr(), tris.data_ptr(), prim.data_ptr(), out.data_ptr(),
            n, t, key_idx_mask(t), float(np.float32(eps)), stream,
        )
    if err != 0:
        raise RuntimeError(f"intersect_best_key kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def best_key_plain(tri_verts: torch.Tensor, tri_prim: torch.Tensor, o: V3, d: V3,
                   ignore_prim: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch twin of K1: the same key over a [T, N] grid, with the
    same FP32 operations in the same order (``intersect_rays_soa2``'s pass 1
    in the JAX package)."""
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
    iota_t = torch.arange(n_tris, dtype=torch.int32, device=dist.device)[:, None]
    key = (dist.view(torch.int32) & ~idx_mask) | iota_t
    key = torch.where(valid, key, INF_BITS)
    return key.min(dim=0).values


def intersect_best_key(tri_verts: torch.Tensor, tri_prim: torch.Tensor, o: V3, d: V3,
                       ignore_prim: torch.Tensor, eps: float) -> torch.Tensor:
    """Closest-hit sweep: rays (V3 o, V3 d, i32[N] ignore) -> best_key
    i32[N].  ``best_key < INF_BITS`` means hit; ``best_key & idx_mask`` is
    the winning triangle.  CUDA tensors launch K1, CPU tensors run the twin."""
    if tri_verts.device.type == "cpu":
        return best_key_plain(tri_verts, tri_prim, o, d, ignore_prim, eps)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z])
    tris = tri_verts.reshape(tri_verts.shape[0], 9).contiguous()
    return best_key_cuda(rays, ignore_prim.to(torch.int32).contiguous(), tris,
                         tri_prim.to(torch.int32).contiguous(), eps)
