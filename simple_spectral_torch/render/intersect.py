"""Closest-hit intersection of lane batches (PyTorch port of
``simple_spectral_tpu.render.intersect``).

Two arms.  The dense arm sends every triangle sweep through kernel K1
(render/intersect_pallas.py), which returns one packed (distance | triangle)
key per ray, exact (64 bits) on the "xla" route and quantized (32 bits) on
the "pallas" route; :func:`intersect_rays_pallas` recovers the winner's
attributes by re-running the watertight test (reference
src/geometry.cpp:12-101) for that single triangle per lane, and
:func:`_merge_spheres_soa` merges a dense sphere sweep into it.  The
block-cull arm (render/cull.py, kernel K2) carries scenes with cluster tiles
from CULL_AUTO_THRESHOLD primitives on.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from simple_spectral_torch.render.intersect_pallas import intersect_best_key, key_parts
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


# Primitive count from which "auto" takes the block-cull arm when the scene
# has cluster tiles: the JAX package's threshold (its end-to-end crossover on
# a TPU), kept so that both packages run the same arm on the same scene.
CULL_AUTO_THRESHOLD = 32768


def resolve_intersect_impl(impl: str, scene=None) -> str:
    """The arm and key a name runs, as in the JAX package.  "auto" resolves
    to "cull" for a scene with cluster tiles and at least
    CULL_AUTO_THRESHOLD primitives, and to "xla" below.  Every dense name
    runs K1: "xla" (and so "auto" below the threshold) with the exact 64-bit
    key, whose winner is the JAX "xla" sweep's ``jnp.argmin`` (least
    distance, first index among exact ties); "xla2" and "pallas" with the
    quantized 32-bit key of the Pallas kernel and of ``intersect_rays_soa2``
    (ties within the dropped mantissa bits to the lower index), resolving to
    "pallas".  "cull" is the block-cull arm (K2) and "bvh" the BVH walk
    (render/bvh.py)."""
    if impl == "auto":
        if (scene is not None and scene.cull_tiles is not None
                and scene.n_tris + scene.n_spheres >= CULL_AUTO_THRESHOLD):
            return "cull"
        return "xla"
    if impl == "xla":
        return "xla"
    if impl in ("xla2", "pallas"):
        return "pallas"
    if impl in ("cull", "bvh"):
        return impl
    raise ValueError(f"unknown intersect_impl {impl!r}")


def intersect_rays_pallas(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                          need_attrs: bool = True, exact: bool = False) -> HitRecord:
    """Closest hit via K1 (the exact key with ``exact``, else the quantized
    one) + recovery of the winner's attributes.

    With ``need_attrs=False`` (shadow rays read only hit/prim/mat) the
    key's distance is returned instead of the recomputed one: exact with
    ``exact``, quantized otherwise."""
    best_key = intersect_best_key(scene.tri_verts, scene.tri_prim, o, d, ignore_prim, eps, exact)
    hit, tri, key_dist = key_parts(best_key, scene.tri_verts.shape[0], exact)
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


def _merge_spheres_soa(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                       tri_rec: HitRecord, need_attrs: bool) -> HitRecord:
    """Dense [Sp, N] sphere sweep merged into the triangle closest hit (the
    JAX package's ``_merge_spheres_soa``, intersect.py:184-260): every sphere
    against every lane, the nearest root >= eps, the least distance, and
    the winner's attributes.  No-op without spheres.  Directions must be
    unit length.  With ``need_attrs=False`` the triangle distance it
    compares with is the key's (quantized on the "pallas" route)."""
    if not scene.n_spheres:
        return tri_rec
    c = scene.sphere_center  # f32[Sp, 3]
    ocx = o.x[None, :] - c[:, 0][:, None]  # [Sp, N]
    ocy = o.y[None, :] - c[:, 1][:, None]
    ocz = o.z[None, :] - c[:, 2][:, None]
    r2 = (scene.sphere_radius * scene.sphere_radius)[:, None]
    bq = ocx * d.x[None, :] + ocy * d.y[None, :] + ocz * d.z[None, :]
    cq = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = bq * bq - cq
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    near = -bq - sq
    far = -bq + sq
    dist = torch.where(near >= eps, near, far)
    not_ign = scene.sphere_prim[:, None] != ignore_prim[None, :]
    valid = (disc > 0.0) & (dist >= eps) & not_ign
    dist = torch.where(valid, dist, INF)

    s_best = dist.amin(dim=0)
    s_idx = dist.argmin(dim=0)  # the first of equal minima, as jnp.argmin
    s_hit = torch.isfinite(s_best)
    wins = s_best < tri_rec.dist  # a sphere closer than the best triangle
    hit = tri_rec.hit | s_hit
    best = torch.where(wins, s_best, tri_rec.dist)
    prim = torch.where(wins, scene.sphere_prim[s_idx], tri_rec.prim)
    mat = torch.where(wins, scene.sphere_mat[s_idx], tri_rec.mat)
    tri = torch.where(wins, 0, tri_rec.tri).to(torch.int32)
    if not need_attrs:
        return HitRecord(hit=hit, dist=best, tri=tri, prim=prim, mat=mat,
                         normal=tri_rec.normal, st_s=tri_rec.st_s, st_t=tri_rec.st_t)

    cx, cy, cz = c[s_idx, 0], c[s_idx, 1], c[s_idx, 2]
    rad = scene.sphere_radius[s_idx]
    safe = torch.where(s_hit, s_best, 0.0)
    inv_r = 1.0 / torch.clamp_min(rad, 1e-30)
    snx = (o.x + safe * d.x - cx) * inv_r
    sny = (o.y + safe * d.y - cy) * inv_r
    snz = (o.z + safe * d.z - cz) * inv_r
    # equirectangular sphere ST (an extension, as in render/bvh.py)
    sph_s = 0.5 + torch.atan2(snz, snx) / (2.0 * math.pi)
    sph_t = 0.5 - torch.asin(torch.clamp(sny, -1.0, 1.0)) / math.pi
    normal = V3(torch.where(wins, snx, tri_rec.normal.x), torch.where(wins, sny, tri_rec.normal.y),
                torch.where(wins, snz, tri_rec.normal.z))
    return HitRecord(hit=hit, dist=best, tri=tri, prim=prim, mat=mat, normal=normal,
                     st_s=torch.where(wins, sph_s, tri_rec.st_s), st_t=torch.where(wins, sph_t, tri_rec.st_t))


def intersect_rays_dispatch(scene: SceneData, o: V3, d: V3, ignore_prim: torch.Tensor, eps: float,
                            need_attrs: bool = True, impl: str = "auto") -> HitRecord:
    """Route the closest-hit sweep to the arm ``impl`` resolves to."""
    arm = resolve_intersect_impl(impl, scene)
    if arm == "bvh":
        from simple_spectral_torch.render.bvh import intersect_rays_bvh

        if scene.bvh_nodes is None:
            raise ValueError("intersect_impl='bvh' but the scene has no BVH (built when the primitive count "
                             "reaches cfg.bvh_threshold, scene/library.py)")
        return intersect_rays_bvh(scene, o, d, ignore_prim, eps, need_attrs)
    if arm == "cull":
        from simple_spectral_torch.render.cull import intersect_rays_cull

        if scene.cull_tiles is None:
            raise ValueError("intersect_impl='cull' but the scene has no cluster tiles "
                             "(built when the primitive count reaches cfg.bvh_threshold)")
        return intersect_rays_cull(scene, o, d, ignore_prim, eps, need_attrs)
    if arm == "pallas" and scene.n_spheres:
        raise ValueError(f"intersect_impl={impl!r} does not support spheres; use bvh/xla")
    rec = intersect_rays_pallas(scene, o, d, ignore_prim, eps, need_attrs, exact=arm == "xla")
    return _merge_spheres_soa(scene, o, d, ignore_prim, eps, rec, need_attrs)


def intersect_rays(scene: SceneData, ray_orig: torch.Tensor, ray_dir: torch.Tensor, ignore_prim: torch.Tensor,
                   eps: float) -> HitRecord:
    """Row-vector entry: f32[N, 3] origins and directions in, a HitRecord
    out (normal as V3), through the exact dense route (K1's exact key and
    the sphere sweep), as the JAX package's ``intersect_rays`` takes its
    exact dense sweep.  Hot code passes V3 lanes to
    :func:`intersect_rays_dispatch` instead."""
    from simple_spectral_torch.render.vec import v3_from_rows

    o, d = v3_from_rows(ray_orig), v3_from_rows(ray_dir)
    rec = intersect_rays_pallas(scene, o, d, ignore_prim, eps, exact=True)
    return _merge_spheres_soa(scene, o, d, ignore_prim, eps, rec, True)
