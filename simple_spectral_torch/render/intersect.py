"""Closest-hit intersection of lane batches (PyTorch port of
``simple_spectral_tpu.render.intersect``).

Every dense closest-hit sweep goes through kernel K1
(render/intersect_pallas.py): it returns one packed (distance | triangle)
key per ray, and :func:`intersect_rays_pallas` recovers the winner's
attributes by re-running the watertight test (reference
src/geometry.cpp:12-101) for that single triangle per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from simple_spectral_torch.config import not_ported
from simple_spectral_torch.render.intersect_pallas import INF_BITS, intersect_best_key, key_idx_mask
from simple_spectral_torch.render.vec import V3, select3
from simple_spectral_torch.scene.types import SceneData

INF = float("inf")


class HitRecord(NamedTuple):
    """SoA hit record for a batch of rays (reference HitRecord,
    src/stdafx.hpp:222-233, flattened to lane vectors)."""

    hit: torch.Tensor  # bool[N]
    dist: torch.Tensor  # f32[N] (INF where miss)
    tri: torch.Tensor  # i32[N] index of the hit triangle (0 where miss)
    prim: torch.Tensor  # i32[N] owning primitive id (-1 where miss)
    mat: torch.Tensor  # i32[N] material id (0 where miss)
    normal: V3  # f32[N] x3 flat geometric normal
    st_s: torch.Tensor  # f32[N] interpolated texture coordinate s
    st_t: torch.Tensor  # f32[N] interpolated texture coordinate t


def _pick_axes(d: V3):
    """Watertight axis permutation: kz = argmax |d|, (kx, ky) cyclic, with
    kx/ky swapped when d[kz] < 0 to preserve winding (reference
    src/geometry.cpp:16-31).  All i64[N]."""
    ax, ay, az = torch.abs(d.x), torch.abs(d.y), torch.abs(d.z)
    x_wins = (ax > ay) & (ax > az)
    y_wins = (~x_wins) & (ay > az)
    kz = torch.where(x_wins, 0, torch.where(y_wins, 1, 2))
    kx = torch.where(kz == 2, 0, kz + 1)
    ky = torch.where(kx == 2, 0, kx + 1)
    dz = select3(kz, d.x, d.y, d.z)
    neg = dz < 0.0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    return kx, ky, kz, dz


def resolve_intersect_impl(impl: str) -> str:
    """Every dense name ("auto", "xla", "xla2", "pallas") resolves to the
    K1 kernel arm.  The JAX package picks its XLA sweep at cornell scale
    from a TPU measurement, which says nothing about this card; here one
    thread per ray over triangles in shared memory is the natural design.
    "bvh" and "cull" are the scale path, not ported yet."""
    if impl in ("auto", "xla", "xla2", "pallas"):
        return "pallas"
    if impl in ("bvh", "cull"):
        raise not_ported(f"intersect_impl {impl!r}", 13)
    raise ValueError(f"unknown intersect_impl {impl!r}")


def intersect_rays_pallas(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                          need_attrs: bool = True) -> HitRecord:
    """Closest hit via K1 + recovery of the winner's attributes.

    With ``need_attrs=False`` (shadow rays read only hit/prim/mat) the
    key's quantized distance is returned instead of the recomputed one."""
    best_key = intersect_best_key(scene.tri_verts, scene.tri_prim, o, d, ignore_prim, eps)
    idx_mask = key_idx_mask(scene.tri_verts.shape[0])
    hit = best_key < INF_BITS
    tri = torch.where(hit, best_key & idx_mask, 0).to(torch.int64)
    prim = torch.where(hit, scene.tri_prim[tri], -1).to(torch.int32)
    mat = torch.where(hit, scene.tri_mat[tri], 0).to(torch.int32)

    if not need_attrs:
        dist_q = (best_key & ~idx_mask).view(torch.float32)
        dist = torch.where(hit, dist_q, INF)
        zero = torch.zeros_like(dist)
        return HitRecord(hit=hit, dist=dist, tri=tri.to(torch.int32), prim=prim, mat=mat,
                         normal=V3(zero, zero, zero), st_s=zero, st_t=zero)

    # --- attribute recovery: one winning triangle per lane ---
    kx, ky, kz, dz = _pick_axes(d)
    inv_dz = 1.0 / torch.where(dz == 0.0, 1.0, dz)
    sx = select3(kx, d.x, d.y, d.z) * inv_dz
    sy = select3(ky, d.x, d.y, d.z) * inv_dz
    sz = inv_dz
    tv = scene.tri_verts[tri]  # f32[N, 3, 3]

    def sheared(vert):
        rx = tv[:, vert, 0] - o.x
        ry = tv[:, vert, 1] - o.y
        rz = tv[:, vert, 2] - o.z
        r_kx = select3(kx, rx, ry, rz)
        r_ky = select3(ky, rx, ry, rz)
        r_kz = select3(kz, rx, ry, rz)
        return r_kx - sx * r_kz, r_ky - sy * r_kz, r_kz

    ax_a, ay_a, az_a = sheared(0)
    ax_b, ay_b, az_b = sheared(1)
    ax_c, ay_c, az_c = sheared(2)
    u = ay_b * ax_c - ax_b * ay_c
    v = ay_c * ax_a - ax_c * ay_a
    w = ay_a * ax_b - ax_a * ay_b
    det = u + v + w
    t_scaled = sz * (u * az_a + v * az_b + w * az_c)
    safe_det = torch.where(det != 0.0, det, 1.0)
    dist = torch.where(hit & (det != 0.0), t_scaled / safe_det, INF)
    nrm = scene.tri_normal[tri]  # f32[N, 3]
    st = scene.tri_st[tri]  # f32[N, 3, 2]
    inv_det = torch.where(det != 0.0, 1.0 / safe_det, 0.0)
    st_s = (u * st[:, 0, 0] + v * st[:, 1, 0] + w * st[:, 2, 0]) * inv_det
    st_t = (u * st[:, 0, 1] + v * st[:, 1, 1] + w * st[:, 2, 1]) * inv_det
    return HitRecord(hit=hit, dist=dist, tri=tri.to(torch.int32), prim=prim, mat=mat,
                     normal=V3(nrm[:, 0], nrm[:, 1], nrm[:, 2]), st_s=st_s, st_t=st_t)


def intersect_rays_dispatch(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                            need_attrs: bool = True, impl: str = "auto") -> HitRecord:
    """Route the closest-hit sweep to the configured implementation."""
    if scene.n_spheres:
        raise not_ported("spheres", 12)
    resolve_intersect_impl(impl)
    return intersect_rays_pallas(scene, o, d, ignore_prim, eps, need_attrs)
