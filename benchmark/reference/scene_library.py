"""Built-in scenes as SoA device tensors (frozen from the renderer's
``scene.library``; cornell, cornell-srgb, plane-srgb).

Re-implements the hard-coded scene constructions of the reference
(``Scene::get_new_cornell`` reference src/scene.cpp:32-287,
``get_new_cornell_srgb`` src/scene.cpp:288-319, ``get_new_plane_srgb``
src/scene.cpp:320-415) as data.  A quad
(v00, v10, v11, v01) becomes two triangles (v00, v10, v11) and
(v00, v11, v01), both tagged with the quad's primitive id (reference
src/geometry.hpp:82-104).

Quirk kept from the reference: the camera's projection aspect uses the
scene's hard-coded 512x512 resolution even when the framebuffer differs
(``Scene::_init`` uses ``camera.res``, reference src/scene.cpp:16-24, while
rendering maps pixels via ``framebuffer.res``, src/renderer.cpp:113-117).

Textures ship as one packed 0xRRGGBB sRGB word per texel for rgb and
mallett (decoded per hit in the shading phase); jakob "u32" ships one q32
word of companded sigmoid coefficients per texel, "rows" its coefficients
f32[T, 3], precomputed here.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.image import load_png_rgb
from benchmark.reference.scene_types import (
    ALBEDO_CONSTANT,
    ALBEDO_TEXTURE,
    BSDF_LAMBERTIAN,
    BSDF_MIRROR,
    Camera,
    MaterialTable,
    SceneData,
    make_camera,
)
from benchmark.reference.colorimetry import ColorTables, srgb_to_lrgb_np
from benchmark.reference.spectrum import Spectrum, data_path, load_spectral_csv
from benchmark.reference.upsample_jakob import jakob_q32_pack, rgb2spec_fetch_soa

SCENE_NAMES = ("cornell", "cornell-srgb", "plane-srgb")


def _common_grid_resample(specs, k_pad: int, lambda_min: float, lambda_max: float):
    """Exact shared lattice for a set of uniform-grid spectra + per-material
    resample matrices, or (None, None) when no exact lattice exists.

    Every material's hat-reconstructed spectrum is piecewise linear with
    breakpoints on its own lattice low_i + Z*step_i.  If one lattice of
    pitch g holds every breakpoint (g divides all steps and all pairwise low
    offsets), resampling onto it is exact over the observable window, and
    the device evaluates all materials with ONE shared hat-weight tensor.

    Returns ((g_low, g_step, kc), R f32[M, kc, k_pad]) with
    resampled = values @ R[m].T reproducing each original spectrum.
    """
    try:
        fr = [(Fraction(repr(float(s.low))), Fraction(repr(float(s.step))), s.values.size) for s in specs]
    except (ValueError, ArithmeticError):
        return None, None
    vals = [st for _, st, _ in fr] + [lo - fr[0][0] for lo, _, _ in fr[1:]]
    vals = [abs(v) for v in vals if v != 0]
    if not vals:
        return None, None
    den = math.lcm(*(v.denominator for v in vals))
    g = Fraction(math.gcd(*(int(v * den) for v in vals)), den)
    if g <= 0:
        return None, None
    lo0 = fr[0][0]
    g_low = lo0 + math.floor((Fraction(repr(float(lambda_min))) - g - lo0) / g) * g
    g_high = lo0 + math.ceil((Fraction(repr(float(lambda_max))) + g - lo0) / g) * g
    kc = int((g_high - g_low) / g) + 1
    if kc > 4096:  # pathological lattice: the shared pass would cost more
        return None, None
    nodes = np.asarray([float(g_low + j * g) for j in range(kc)], np.float64)
    r = np.zeros((len(specs), kc, k_pad), np.float32)
    for i, s in enumerate(specs):
        x = (nodes - float(s.low)) / float(s.step)
        kk = np.arange(s.values.size, dtype=np.float64)
        r[i, :, : s.values.size] = np.maximum(0.0, 1.0 - np.abs(x[:, None] - kk[None, :]))
    return (float(g_low), float(g), kc), r


class _HostMaterial:
    """Host-side material description gathered before packing."""

    def __init__(
        self,
        bsdf: int = BSDF_LAMBERTIAN,
        albedo_spec: Optional[Spectrum] = None,
        albedo_rgb: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        emission_spec: Optional[Spectrum] = None,
        emission_rgb: Tuple[float, float, float] = (0.0, 0.0, 0.0),
        tex_id: int = -1,
    ):
        self.bsdf = bsdf
        self.albedo_spec = albedo_spec
        self.albedo_rgb = albedo_rgb
        self.emission_spec = emission_spec
        self.emission_rgb = emission_rgb
        self.tex_id = tex_id

    def is_emissive(self, spectral: bool) -> bool:
        # reference src/material.cpp:100-106
        if spectral:
            return self.emission_spec is not None and self.emission_spec.integrate() > 0.0
        return any(c > 0.0 for c in self.emission_rgb)


class _Assembly:
    def __init__(self, cfg: RenderConfig, tables: ColorTables, device):
        self.cfg = cfg
        self.tables = tables
        self.device = torch.device(device)
        self.materials: List[_HostMaterial] = []
        self.mat_names: dict = {}
        self.quads: List[tuple] = []  # (mat_id, verts f64[4,3], sts f64[4,2])
        self.spheres: List[tuple] = []  # (mat_id, center f64[3], radius)
        self.texture: Optional[np.ndarray] = None
        self.camera_fn = None

    def add_material(self, name: str, mat: _HostMaterial) -> int:
        mid = len(self.materials)
        self.materials.append(mat)
        self.mat_names[name] = mid
        return mid

    def add_quad(self, mat: int, v00, v10, v11, v01, st00=(0, 0), st10=(0, 0), st11=(0, 0), st01=(0, 0)):
        verts = np.asarray([v00, v10, v11, v01], dtype=np.float64)
        sts = np.asarray([st00, st10, st11, st01], dtype=np.float64)
        self.quads.append((mat, verts, sts))

    def add_sphere(self, mat: int, center, radius: float):
        """Sphere primitive (an extension: the reference has none).  Emissive
        spheres join the light list and are sampled with the cone-cap
        sampler (render/sampling.py rand_toward_sphere)."""
        self.spheres.append((mat, np.asarray(center, np.float64), float(radius)))

    def const_spectrum(self, value: float) -> Spectrum:
        """Constant spectrum over [LAMBDA_MIN, LAMBDA_MAX] (reference
        src/spectrum.cpp:11-13)."""
        return Spectrum.constant(value, self.cfg.lambda_min, self.cfg.lambda_max)

    def load_texture(self) -> int:
        """Load the scene texture (sRGB u8, scanlines top to bottom;
        reference src/material.cpp:10-29).  Returns the texture id."""
        if self.texture is None:
            self.texture = scene_texture(self.cfg)
        return 0

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def finish(self, name: str) -> SceneData:
        cfg = self.cfg
        spectral = cfg.spectral
        f32, i32 = torch.float32, torch.int32
        m = len(self.materials)
        zero = self.const_spectrum(0.0)
        alb_specs = [mat.albedo_spec if mat.albedo_spec is not None else self.const_spectrum(1.0)
                     for mat in self.materials]
        emi_specs = [mat.emission_spec if mat.emission_spec is not None else zero for mat in self.materials]
        ka = max(s.values.size for s in alb_specs)
        ke = max(s.values.size for s in emi_specs)

        def pack(specs, k):
            # zero padding past each spectrum's own sample count reproduces
            # the reference's zero-outside-range semantics (spectrum.cpp:39-60)
            vals = np.zeros((m, k), dtype=np.float32)
            low = np.zeros(m, dtype=np.float32)
            inv_step = np.ones(m, dtype=np.float32)
            for i, s in enumerate(specs):
                vals[i, : s.values.size] = s.values
                low[i] = s.low
                inv_step[i] = 1.0 / s.step
            return vals, low, inv_step

        alb_vals, alb_low, alb_inv = pack(alb_specs, ka)
        emi_vals, emi_low, emi_inv = pack(emi_specs, ke)
        alb_grid, alb_res = _common_grid_resample(alb_specs, ka, cfg.lambda_min, cfg.lambda_max)
        emi_grid, emi_res = _common_grid_resample(emi_specs, ke, cfg.lambda_min, cfg.lambda_max)

        t = self._tensor
        materials = MaterialTable(
            bsdf_type=t([mat.bsdf for mat in self.materials], i32),
            albedo_kind=t([ALBEDO_TEXTURE if mat.tex_id >= 0 else ALBEDO_CONSTANT for mat in self.materials], i32),
            albedo_values=t(alb_vals, f32),
            albedo_low=t(alb_low, f32),
            albedo_inv_step=t(alb_inv, f32),
            emission_values=t(emi_vals, f32),
            emission_low=t(emi_low, f32),
            emission_inv_step=t(emi_inv, f32),
            albedo_rgb=t([mat.albedo_rgb for mat in self.materials], f32),
            emission_rgb=t([mat.emission_rgb for mat in self.materials], f32),
            tex_id=t([mat.tex_id for mat in self.materials], i32),
            albedo_resample=None if alb_res is None else t(alb_res, f32),
            emission_resample=None if emi_res is None else t(emi_res, f32),
            albedo_grid=alb_grid,
            emission_grid=emi_grid,
            n_materials=m,
        )

        # --- geometry: quad -> 2 triangles, same prim id ---
        tri_verts, tri_st, tri_mat, tri_prim = [], [], [], []
        emissive = [mat.is_emissive(spectral) for mat in self.materials]
        light_tris, light_prims = [], []
        for prim_id, (mat_id, v, st) in enumerate(self.quads):
            t0 = len(tri_verts)
            tri_verts += [v[[0, 1, 2]], v[[0, 2, 3]]]
            tri_st += [st[[0, 1, 2]], st[[0, 2, 3]]]
            tri_mat += [mat_id, mat_id]
            tri_prim += [prim_id, prim_id]
            if emissive[mat_id]:
                light_tris.append((t0, t0 + 1))
                light_prims.append(prim_id)
        if not light_prims:
            raise ValueError("scene must have at least one light (reference src/scene.cpp:30)")
        tv = np.asarray(tri_verts, dtype=np.float64)  # [T, 3, 3]
        # flat normal = normalize(cross(v1-v0, v2-v0)) (reference src/geometry.hpp:68)
        nrm = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)

        # spheres: primitive ids continue after the quads; emissive ones join
        # the light list as kind-1 rows with placeholder triangle indices
        n_spheres = len(self.spheres)
        light_kind = [0] * len(light_prims)
        light_sph = [(0.0, 0.0, 0.0, 0.0)] * len(light_prims)
        sp_center = sp_radius = sp_prim = sp_mat = None
        sphere_kw = {}
        if n_spheres:
            for si, (mat_id, c, r) in enumerate(self.spheres):
                if emissive[mat_id]:
                    light_prims.append(len(self.quads) + si)
                    light_tris.append((0, 0))
                    light_kind.append(1)
                    light_sph.append((float(c[0]), float(c[1]), float(c[2]), float(r)))
            sp_center = np.asarray([c for _, c, _ in self.spheres], np.float64)
            sp_radius = np.asarray([r for _, _, r in self.spheres], np.float64)
            sp_mat = np.asarray([m for m, _, _ in self.spheres], np.int32)
            sp_prim = np.arange(len(self.quads), len(self.quads) + n_spheres, dtype=np.int32)
            sphere_kw = dict(sphere_center=t(sp_center, f32), sphere_radius=t(sp_radius, f32),
                             sphere_prim=t(sp_prim, i32), sphere_mat=t(sp_mat, i32))

        texture = tex_meta = None
        if self.texture is not None:
            if spectral and cfg.mode == "jakob" and cfg.texel_format == "rows":
                texture = texel_jakob_rows(self.tables.jakob, self.texture, self.device)
            elif spectral and cfg.mode == "jakob":
                texture, tex_meta = texel_jakob_q32(self.tables.jakob, self.texture, self.device)
            else:
                # rgb and mallett: packed sRGB words, decoded in
                # the shading phase from the raw texel
                words = (
                    (self.texture[..., 0].astype(np.int64) << 16)
                    | (self.texture[..., 1].astype(np.int64) << 8)
                    | self.texture[..., 2].astype(np.int64)
                ).reshape(-1)
                texture = t(words, i32)
        return SceneData(
            tri_verts=t(tv, f32),
            tri_st=t(np.asarray(tri_st), f32),
            tri_normal=t(nrm, f32),
            tri_prim=t(tri_prim, i32),
            tri_mat=t(tri_mat, i32),
            light_tris=t(light_tris, i32),
            light_prims=t(light_prims, i32),
            light_kind=t(light_kind, i32),
            light_sph=t(light_sph, f32),
            materials=materials,
            camera=self.camera_fn(),
            texture=texture,
            texel_meta=tex_meta,
            **sphere_kw,
            n_tris=len(tri_mat),
            n_prims=len(self.quads) + n_spheres,
            n_lights=len(light_prims),
            n_sphere_lights=sum(light_kind),
            n_spheres=n_spheres,
            name=name,
            tex_res=(
                (int(self.texture.shape[1]), int(self.texture.shape[0])) if self.texture is not None else (0, 0)
            ),
        )


def scene_texture(cfg: RenderConfig) -> np.ndarray:
    """The scene's texture, sRGB u8 [H, W, 3], scanlines top to bottom
    (reference src/material.cpp:10-29)."""
    return load_png_rgb(data_path("scenes", cfg.texture))


def _texel_lrgb(texture: np.ndarray, device):
    """The texture as linear-RGB channels f32[T] x3 on ``device``, for the
    per-texel upsample precomputations."""
    lrgb = srgb_to_lrgb_np(np.asarray(texture, np.float32).reshape(-1, 3) / 255.0)
    return tuple(torch.as_tensor(np.ascontiguousarray(lrgb[:, c]), dtype=torch.float32, device=device)
                 for c in range(3))


def texel_jakob_rows(jakob: dict, texture: np.ndarray, device) -> torch.Tensor:
    """Per-texel sigmoid coefficients f32[T, 3] (texel_format="rows"): the
    cube fetch the reference does per hit (src/material.cpp:45-64) depends
    only on the texel, so it runs once at scene build, on ``device``."""
    c0, c1, c2 = rgb2spec_fetch_soa(jakob, *_texel_lrgb(texture, device))
    return torch.stack([c0, c1, c2], dim=-1)


def texel_jakob_q32(jakob: dict, texture: np.ndarray, device):
    """Per-texel q32 words (texel_format="u32"): the same cube fetch on
    ``device``, then the host pack (spectra/upsample_jakob.py).  Returns
    (words i32[T] holding the u32 bits, meta f32[9])."""
    c0, c1, c2 = rgb2spec_fetch_soa(jakob, *_texel_lrgb(texture, device))
    words, meta = jakob_q32_pack(*(c.cpu().numpy() for c in (c0, c1, c2)))
    return (torch.as_tensor(words.view(np.int32), device=device),
            torch.as_tensor(meta, dtype=torch.float32, device=device))


def _cornell_assembly(cfg: RenderConfig, tables: ColorTables, device) -> _Assembly:
    b = _Assembly(cfg, tables, device)
    spectral = cfg.spectral

    # Camera (reference src/scene.cpp:36-46); projection aspect uses the
    # scene's hard-coded 512x512, not the framebuffer resolution.
    def cam() -> Camera:
        return make_camera(
            pos=(278.0, 273.0, -800.0), direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
            res=(512, 512), vfov_deg=39.0, near=0.1, far=1.0, device=b.device,
        )

    b.camera_fn = cam

    # Materials (reference src/scene.cpp:48-105).
    if spectral:
        wgr = load_spectral_csv("scenes/cornell/white-green-red.csv")
        white = Spectrum(wgr[0], 400.0, 700.0)
        green = Spectrum(wgr[1], 400.0, 700.0)
        red = Spectrum(wgr[2], 400.0, 700.0)
        light_emission = Spectrum(load_spectral_csv("scenes/cornell/light.csv")[0], 400.0, 700.0) * 200.0
        b.add_material("white-back", _HostMaterial(albedo_spec=white))
        b.add_material("white-blocks", _HostMaterial(albedo_spec=white))
        b.add_material("white-floorceil", _HostMaterial(albedo_spec=white))
        b.add_material("green", _HostMaterial(albedo_spec=green))
        b.add_material("red", _HostMaterial(albedo_spec=red))
        b.add_material("light", _HostMaterial(albedo_spec=b.const_spectrum(0.78), emission_spec=light_emission))
    else:
        # RGB-mode constants (reference src/scene.cpp:68-82,99-103).
        b.add_material("white-back", _HostMaterial(albedo_rgb=(1, 1, 1)))
        b.add_material("white-blocks", _HostMaterial(albedo_rgb=(1, 1, 1)))
        b.add_material("white-floorceil", _HostMaterial(albedo_rgb=(1, 1, 1)))
        b.add_material("green", _HostMaterial(albedo_rgb=(0.07, 0.38, 0.07)))
        b.add_material("red", _HostMaterial(albedo_rgb=(1, 0, 0)))
        b.add_material("light", _HostMaterial(albedo_rgb=(0.78, 0.78, 0.78), emission_rgb=(200.0, 200.0, 200.0)))

    N = b.mat_names
    # Floor (reference src/scene.cpp:108-114)
    b.add_quad(
        N["white-floorceil"],
        (552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2),
        (1, 0), (0, 0), (0, 1), (1, 1),
    )
    # Ceiling with a hole for the light (reference src/scene.cpp:134-193).
    A = (0.0, 548.8, 559.2)
    B = (556.0, 548.8, 559.2)
    C = (0.0, 548.8, 0.0)
    D = (556.0, 548.8, 0.0)
    E = (213.0, 548.8, 332.0)
    F = (343.0, 548.8, 332.0)
    G = (213.0, 548.8, 227.0)
    H = (343.0, 548.8, 227.0)
    b.add_quad(N["light"], H, F, E, G, (1, 0), (1, 1), (0, 1), (0, 0))
    b.add_quad(N["white-floorceil"], D, B, F, H)
    b.add_quad(N["white-floorceil"], B, A, E, F)
    b.add_quad(N["white-floorceil"], A, C, G, E)
    b.add_quad(N["white-floorceil"], C, D, H, G)
    # Back wall (reference src/scene.cpp:196-201)
    b.add_quad(
        N["white-back"],
        (549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2),
        (0, 0), (1, 0), (1, 1), (0, 1),
    )
    # Right wall, green (reference src/scene.cpp:204-209)
    b.add_quad(
        N["green"],
        (0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2),
        (1, 0), (0, 0), (0, 1), (1, 1),
    )
    # Left wall, red (reference src/scene.cpp:212-217)
    b.add_quad(
        N["red"],
        (552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0),
        (0, 0), (1, 0), (1, 1), (0, 1),
    )
    # Short block (reference src/scene.cpp:220-249)
    W = N["white-blocks"]
    b.add_quad(W, (130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114))
    b.add_quad(W, (290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272))
    b.add_quad(W, (130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114))
    b.add_quad(W, (82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65))
    b.add_quad(W, (240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225))
    # Tall block (reference src/scene.cpp:252-281)
    b.add_quad(W, (423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406))
    b.add_quad(W, (423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406))
    b.add_quad(W, (472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456))
    b.add_quad(W, (314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296))
    b.add_quad(W, (265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247))
    return b


def _cornell(cfg: RenderConfig, tables: ColorTables, device) -> SceneData:
    return _cornell_assembly(cfg, tables, device).finish("cornell")


def _cornell_srgb(cfg: RenderConfig, tables: ColorTables, device) -> SceneData:
    """Cornell variant: blocks/floor/ceiling -> plain white, red wall -> sRGB
    texture, light -> D65 x 30 (reference src/scene.cpp:288-319)."""
    b = _cornell_assembly(cfg, tables, device)
    spectral = cfg.spectral
    tex = b.load_texture()
    srgb_id = b.add_material("srgb", _HostMaterial(tex_id=tex))
    if spectral:
        white1_id = b.add_material("white1", _HostMaterial(albedo_spec=b.const_spectrum(1.0)))
    else:
        white1_id = b.add_material("white1", _HostMaterial(albedo_rgb=(1, 1, 1)))
    remap = {
        b.mat_names["white-blocks"]: white1_id,
        b.mat_names["white-floorceil"]: white1_id,
        b.mat_names["red"]: srgb_id,
    }
    b.quads = [(remap.get(mid, mid), v, st) for (mid, v, st) in b.quads]
    lightsc = 30.0
    light = b.materials[b.mat_names["light"]]
    if spectral:
        light.emission_spec = tables.host["d65_rad"] * lightsc
    else:
        light.emission_rgb = (lightsc, lightsc, lightsc)
    return b.finish("cornell-srgb")


def _plane_srgb(cfg: RenderConfig, tables: ColorTables, device) -> SceneData:
    """Textured unit quad facing the camera inside a box of D65 light quads
    (reference src/scene.cpp:320-415, the paper's Fig. 1)."""
    b = _Assembly(cfg, tables, device)
    spectral = cfg.spectral
    cam_pos = np.array([0.0, 0.0, 5.0])
    vfov = np.degrees(2.0 * np.arctan2(1.0, cam_pos[2]))

    def cam() -> Camera:
        return make_camera(
            pos=cam_pos, direction=-cam_pos / np.linalg.norm(cam_pos), up=(0.0, 1.0, 0.0),
            res=(512, 512), vfov_deg=float(vfov), near=0.1, far=1.0, device=b.device,
        )

    b.camera_fn = cam
    if spectral:
        light_id = b.add_material(
            "light", _HostMaterial(albedo_spec=b.const_spectrum(0.0), emission_spec=tables.host["d65_rad"] * 1.0))
    else:
        light_id = b.add_material("light", _HostMaterial(albedo_rgb=(0, 0, 0), emission_rgb=(1, 1, 1)))
    tex = b.load_texture()
    # With ELS the textured quad is Lambertian; without, a mirror converges to
    # the same image much faster (reference src/scene.cpp:346-362).
    tex_bsdf = BSDF_LAMBERTIAN if cfg.els else BSDF_MIRROR
    tex_id = b.add_material("tex", _HostMaterial(bsdf=tex_bsdf, tex_id=tex))
    b.add_quad(tex_id, (-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0), (0, 0), (1, 0), (1, 1), (0, 1))
    s = 10.0
    b.add_quad(light_id, (-s, -s, s), (-s, -s, -s), (-s, s, -s), (-s, s, s))
    b.add_quad(light_id, (s, -s, -s), (s, -s, s), (s, s, s), (s, s, -s))
    b.add_quad(light_id, (-s, -s, s), (s, -s, s), (s, -s, -s), (-s, -s, -s))
    b.add_quad(light_id, (s, s, s), (-s, s, s), (-s, s, -s), (s, s, -s))
    b.add_quad(light_id, (-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s))
    b.add_quad(light_id, (s, -s, s), (-s, -s, s), (-s, s, s), (s, s, s))
    return b.finish("plane-srgb")


def build_scene(cfg: RenderConfig, tables: ColorTables, device="cuda") -> SceneData:
    """Build the scene named by ``cfg.scene`` (reference src/renderer.cpp:16-38)
    with its tensors on ``device``."""
    device = torch.device(device)
    if cfg.scene == "cornell":
        return _cornell(cfg, tables, device)
    if cfg.scene == "cornell-srgb":
        return _cornell_srgb(cfg, tables, device)
    if cfg.scene == "plane-srgb":
        return _plane_srgb(cfg, tables, device)
    raise ValueError(f"unrecognized scene {cfg.scene!r}; supported: {SCENE_NAMES}")
