"""Closest hit of lane batches: the plain path of the renderer's dense
closest-hit sweep, frozen here as the benchmark's reference.

The closest triangle is the least exact key ``(bitcast_i32(dist) << 32) |
triangle_index`` over a ``[T, N]`` grid of watertight tests (reference
src/geometry.cpp:12-101), the least distance with exact ties going to the
first index; the winner's attributes are then recovered by re-running the
test for that one triangle per lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.scene_types import SceneData
from benchmark.reference.vec import V3, select3

INF = float("inf")
INF_BITS = 0x7F800000  # bit pattern of +inf as int32
INF_KEY64 = INF_BITS << 32  # the exact key of a miss
_LOW32 = 0xFFFFFFFF


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


def key_parts(key: torch.Tensor):
    """(hit bool[N], triangle i64[N], distance f32[N]) of exact best keys,
    inf where the ray missed."""
    hit = key < INF_KEY64
    tri = key & _LOW32
    dist = (key >> 32).to(torch.int32).view(torch.float32)
    return hit, torch.where(hit, tri, 0), torch.where(hit, dist, torch.inf)


def best_key_plain(tri_verts: torch.Tensor, tri_prim: torch.Tensor, o: V3, d: V3,
                   ignore_prim: torch.Tensor, eps: float) -> torch.Tensor:
    """The exact best key i64[N] over a [T, N] grid of watertight tests."""
    eps = float(np.float32(eps))
    n_tris = tri_verts.shape[0]
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
    iota_t = torch.arange(n_tris, dtype=torch.int64, device=dist.device)[:, None]
    key = torch.where(valid, (dist.view(torch.int32).to(torch.int64) << 32) | iota_t, INF_KEY64)
    return key.min(dim=0).values


def intersect_rays(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                   need_attrs: bool = True) -> HitRecord:
    """Closest hit by the exact key of :func:`best_key_plain`, then the
    winner's attributes.  With ``need_attrs=False`` (shadow rays read only
    hit/prim/mat) the key's exact distance is returned."""
    if scene.n_spheres:
        raise ValueError("the reference intersects triangles only")
    best_key = best_key_plain(scene.tri_verts, scene.tri_prim, o, d, ignore_prim, eps)
    hit, tri, key_dist = key_parts(best_key)
    prim = torch.where(hit, scene.tri_prim[tri], -1).to(torch.int32)
    mat = torch.where(hit, scene.tri_mat[tri], 0).to(torch.int32)

    if not need_attrs:
        zero = torch.zeros_like(key_dist)
        return HitRecord(hit=hit, dist=key_dist, tri=tri.to(torch.int32), prim=prim, mat=mat,
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
