"""Scene as structure-of-arrays device tensors (PyTorch port of
``simple_spectral_tpu.scene.types``).

Triangles carry a material id and an owning-primitive id (quads are two
triangles, reference src/geometry.hpp:82-104); materials are a table indexed
by id with branchless selection in the integrator; spheres, the BVH and the
cluster tiles of the scale path are optional leaves.  The dataclasses hold
tensors plus static Python fields and move with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

# Material BSDF types (reference src/material.hpp:153-178).
BSDF_LAMBERTIAN = 0
BSDF_MIRROR = 1

# Albedo source (reference MaterialSimpleAlbedoBase::MODE, src/material.hpp:119).
ALBEDO_CONSTANT = 0
ALBEDO_TEXTURE = 1


def _to(obj, device):
    """dataclasses.replace with every tensor (or nested dataclass with a
    ``to``) field moved to ``device``."""
    moved = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or (dataclasses.is_dataclass(v) and hasattr(v, "to")):
            moved[f.name] = v.to(device)
    return dataclasses.replace(obj, **moved)


@dataclasses.dataclass
class Camera:
    """Pinhole camera: ``dir ~ normalize(axis_o + x axis_x + y axis_y)`` for
    NDC (x, y), factored on the host in float64 (see :func:`make_camera`)."""

    pos: torch.Tensor  # f32[3]
    axis_o: torch.Tensor  # f32[3]
    axis_x: torch.Tensor  # f32[3]
    axis_y: torch.Tensor  # f32[3]
    forward: torch.Tensor  # f32[3], for flat-field correction
    res: Tuple[int, int] = (512, 512)

    to = _to


@dataclasses.dataclass
class MaterialTable:
    """Dense material table; its four ``*_values``/``*_rgb`` tensors are the
    renderer's differentiable leaves."""

    bsdf_type: torch.Tensor  # i32[M]
    albedo_kind: torch.Tensor  # i32[M]
    albedo_values: torch.Tensor  # f32[M, Ka] per-material uniform grids, zero padded
    albedo_low: torch.Tensor  # f32[M]
    albedo_inv_step: torch.Tensor  # f32[M]
    emission_values: torch.Tensor  # f32[M, Ke]
    emission_low: torch.Tensor  # f32[M]
    emission_inv_step: torch.Tensor  # f32[M]
    albedo_rgb: torch.Tensor  # f32[M, 3]
    emission_rgb: torch.Tensor  # f32[M, 3]
    tex_id: torch.Tensor  # i32[M]; -1 = no texture
    # exact shared-lattice resample (scene/library.py _common_grid_resample)
    albedo_resample: Optional[torch.Tensor] = None  # f32[M, Kc_a, Ka]
    emission_resample: Optional[torch.Tensor] = None  # f32[M, Kc_e, Ke]
    albedo_grid: Any = None  # (g_low, g_step, Kc)
    emission_grid: Any = None
    n_materials: int = 0

    to = _to


@dataclasses.dataclass
class SceneData:
    # geometry, SoA over triangles (quads = 2 triangles re-tagged to one prim)
    tri_verts: torch.Tensor  # f32[T, 3, 3]
    tri_st: torch.Tensor  # f32[T, 3, 2]
    tri_normal: torch.Tensor  # f32[T, 3]
    tri_prim: torch.Tensor  # i32[T]
    tri_mat: torch.Tensor  # i32[T]
    # lights: per light primitive its two triangle indices + its prim id
    light_tris: torch.Tensor  # i32[L, 2]
    light_prims: torch.Tensor  # i32[L]
    materials: MaterialTable
    camera: Camera
    # texture, one entry per texel, scanlines top to bottom: packed 0xRRGGBB
    # sRGB words i32[T] (rgb, mallett, meng "u32"), jakob q32 words i32[T]
    # (the u32 bits; bit 31 set makes a word negative), or f32 rows: jakob
    # coefficients [T, 3] or meng point ids and weights [T, 12] ("rows")
    texture: Optional[torch.Tensor] = None
    texel_meta: Optional[torch.Tensor] = None  # f32[9]: jakob q32 (lo, step, sigma) x3
    light_kind: Optional[torch.Tensor] = None  # i32[L]: 0 quad, 1 sphere
    light_sph: Optional[torch.Tensor] = None  # f32[L, 4]: (cx, cy, cz, r); zeros for quads
    # sphere primitives (an extension of the reference); emissive ones join
    # the light list with light_kind 1.  None when the scene has none.
    sphere_center: Optional[torch.Tensor] = None  # f32[Sp, 3]
    sphere_radius: Optional[torch.Tensor] = None  # f32[Sp]
    sphere_prim: Optional[torch.Tensor] = None  # i32[Sp] owning primitive id
    sphere_mat: Optional[torch.Tensor] = None  # i32[Sp]
    # flattened skip-link BVH (render/bvh.py), built on the host once the
    # primitive count reaches cfg.bvh_threshold
    bvh_nodes: Optional[torch.Tensor] = None  # f32[Nn, 12] packed rows
    bvh_entry_ref: Optional[torch.Tensor] = None  # i32[Nn]: tri/sphere index, -1 internal
    bvh_entry_mat: Optional[torch.Tensor] = None  # i32[Nn]
    # block-cull cluster tiles (render/cull.py), built beside the BVH
    cull_tiles: Optional[torch.Tensor] = None  # f32[C, 1+L, 128]
    cull_entry_ref: Optional[torch.Tensor] = None  # i32[C*(1+L)]
    cull_entry_mat: Optional[torch.Tensor] = None  # i32[C*(1+L)]
    n_tris: int = 0
    n_prims: int = 0
    n_lights: int = 0
    n_sphere_lights: int = 0
    n_spheres: int = 0
    n_bvh_entries: int = 0
    name: str = ""
    tex_res: Tuple[int, int] = (0, 0)  # (W, H)

    to = _to

    @property
    def device(self) -> torch.device:
        return self.tri_verts.device


# --- host-side camera math (float64; init-time only) ---


def perspective_fov(fovy_rad: float, width: float, height: float, z_near: float, z_far: float) -> np.ndarray:
    """glm::perspectiveFov (RH, GL clip depth [-1,1]), row-major numpy."""
    h = np.cos(0.5 * fovy_rad) / np.sin(0.5 * fovy_rad)
    w = h * height / width
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    return m


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """glm::lookAt (RH), row-major numpy."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def make_camera(
    pos, direction, up, res: Tuple[int, int], vfov_deg: float, near: float, far: float,
    device="cpu", dtype=torch.float32,
) -> Camera:
    """Device camera from the reference's parameters.  The reference
    unprojects NDC (x, y, 0, 1) through (P V)^-1 in double precision
    (reference src/renderer.cpp:127-132); for a pinhole P the unprojected
    direction is affine in (x, y), so the factorization is done here in
    float64 and the device evaluates ``axis_o + x axis_x + y axis_y``."""
    pos = np.asarray(pos, dtype=np.float64)
    direction = np.asarray(direction, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    p = perspective_fov(np.radians(vfov_deg), float(res[0]), float(res[1]), near, far)
    v = look_at(pos, pos + direction, up)
    pv_inv = np.linalg.inv(p @ v)
    c0, c1, c3 = pv_inv[:, 0], pv_inv[:, 1], pv_inv[:, 3]
    if abs(c0[3]) >= 1e-12 or abs(c1[3]) >= 1e-12:
        raise ValueError("non-pinhole projection")
    w3 = c3[3]
    axis_o = c3[:3] / w3 - pos
    axis_x = c0[:3] / w3
    axis_y = c1[:3] / w3
    scale = 1.0 / np.linalg.norm(axis_o)  # f32 conditioning: |axis_o| ~ 1
    fwd = direction / np.linalg.norm(direction)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Camera(
        pos=dev(pos),
        axis_o=dev(axis_o * scale),
        axis_x=dev(axis_x * scale),
        axis_y=dev(axis_y * scale),
        forward=dev(fwd),
        res=(int(res[0]), int(res[1])),
    )
