"""Wavefront path-tracing integrator (PyTorch port of
``simple_spectral_tpu.render.integrator``).

One lane is one (pixel, sample) pair: positions are V3 tuples of ``f32[N]``,
spectra ``f32[S, N]``.  The integrator runs in two phases:

1. **Geometry** (unrolled over depth): closest hit, NEE light sample and
   shadow hit, BSDF direction sample.  It reads no albedo value, so it is
   constant with respect to the material tables and runs under
   ``torch.no_grad()`` -- the counterpart of the JAX package's
   ``stop_gradient`` on the geometry records.
2. **Shading** (straight-line over depth): every bounce's albedo -- constant
   spectra by material-row selection, textured materials by one merged
   texel fetch + spectral upsampling -- then throughput, emission and NEE
   radiance, and the hero-wavelength XYZ estimator.

In a profile the sweeps run in ``ss.intersect`` spans and phase 2 in one
``ss.shading`` span (``utils.profiling.span``).

Random numbers come from explicit threefry keys split in the JAX package's
order, so a lane here traces the same path as the same lane there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.intersect import intersect_rays_dispatch
from simple_spectral_torch.render.sampling import (
    rand_toward_sphere,
    rand_toward_spherical_triangle,
    spherical_triangle,
    uniform,
)
from simple_spectral_torch.render.shading import (
    MAT_ROWS_CONTRACTION_THRESHOLD,
    PI,
    is_mirror_mask,
    is_textured_mask,
    material_onehot,
    precompute_basis_hero,
    precompute_constant_spectra,
    sample_bsdf_direction,
    select_column,
    texel_index,
    texture_albedo_deferred,
)
from simple_spectral_torch.render.vec import V3, dot, normalize, splat
from simple_spectral_torch.render.vec import where as v3where
from simple_spectral_torch.scene.types import SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables, specradflux_to_ciexyz_hero_soa
from simple_spectral_torch.utils.profiling import span


def camera_rays_soa(scene: SceneData, cfg: RenderConfig, key, px_i: torch.Tensor, px_j: torch.Tensor):
    """Primary rays through jittered subpixel positions, evaluated through
    the host-factored affine camera (scene.types.make_camera)."""
    cam = scene.camera
    n = px_i.shape[0]
    ka, kb = rnd.split(key)
    sub_x = uniform(ka, (n,), px_i.device)
    sub_y = uniform(kb, (n,), px_i.device)
    ndc_x = (px_i.to(torch.float32) + sub_x) * (2.0 / cfg.width) - 1.0
    ndc_y = (px_j.to(torch.float32) + sub_y) * (2.0 / cfg.height) - 1.0
    d = normalize(
        V3(
            cam.axis_o[0] + ndc_x * cam.axis_x[0] + ndc_y * cam.axis_y[0],
            cam.axis_o[1] + ndc_x * cam.axis_x[1] + ndc_y * cam.axis_y[1],
            cam.axis_o[2] + ndc_x * cam.axis_x[2] + ndc_y * cam.axis_y[2],
        )
    )
    return splat(cam.pos, ndc_x), d


def _sample_light_dir(key, scene: SceneData, from_pos: V3):
    """Uniform-over-lights NEE direction sample (reference
    src/scene.cpp:417-431 + src/geometry.cpp:103-116,141-145).

    Returns (dir V3[N], inv_pdf f32[N], light_prim i32[N]); the inverse pdf
    (solid angle * 2 * n_lights for a quad, cap area * n_lights for a
    sphere) makes a degenerate triangle contribute exactly 0.  Sphere lights
    draw their cone-cap sample from ``k_tri``, the key of the quad's
    triangle choice, as the JAX package does (integrator.py:155)."""
    n = from_pos.x.shape[0]
    device = from_pos.x.device
    k_choice, k_tri, k_arvo = rnd.split(key, 3)
    n_lights = scene.n_lights
    light_idx = rnd.randint(k_choice, (n,), 0, n_lights, device=device)
    light_prim = select_column(scene.light_prims, light_idx, n_lights)
    # 50/50 triangle choice within the quad (reference src/geometry.cpp:141-145)
    pick = (uniform(k_tri, (n,), device) > 0.5).to(torch.int32)
    flat_choice = light_idx * 2 + pick  # index into light_tris.reshape(-1)
    # per-lane light-triangle vertices as one one-hot contraction over the
    # 2L light triangles (exactly one nonzero term per lane: exact in f32)
    lt_verts = scene.tri_verts[scene.light_tris.reshape(-1).to(torch.int64)]  # [2L, 3, 3]
    iota_l = torch.arange(2 * n_lights, dtype=torch.int32, device=device)[:, None]
    oh_l = (iota_l == flat_choice[None, :]).to(torch.float32)  # [2L, N]
    verts = torch.einsum("lva,ln->van", lt_verts, oh_l)  # [3, 3, N]

    def vert(v):
        return V3(verts[v, 0], verts[v, 1], verts[v, 2])

    a = normalize(vert(0) - from_pos)
    b = normalize(vert(1) - from_pos)
    c = normalize(vert(2) - from_pos)
    tri = spherical_triangle(a, b, c)
    d = rand_toward_spherical_triangle(k_arvo, tri)
    inv_pdf = tri.area * (2.0 * n_lights)
    if scene.n_sphere_lights:
        # per-lane sphere parameters: one one-hot contraction over the L
        # lights (kind-0 rows are zeros; one nonzero term: exact in f32)
        oh = (torch.arange(n_lights, dtype=torch.int32, device=device)[:, None]
              == light_idx[None, :]).to(torch.float32)  # [L, N]
        sph = torch.einsum("lc,ln->cn", scene.light_sph, oh)  # [4, N]
        is_sph = select_column(scene.light_kind.to(torch.float32), light_idx, n_lights) > 0.5
        to_c = V3(sph[0] - from_pos.x, sph[1] - from_pos.y, sph[2] - from_pos.z)
        d_sph, cap_area = rand_toward_sphere(k_tri, to_c, sph[3])
        d = v3where(is_sph, d_sph, d)
        inv_pdf = torch.where(is_sph, cap_area * n_lights, inv_pdf)
    return d, inv_pdf, light_prim


def _mat_rows(table: torch.Tensor, mat_k: torch.Tensor, n_materials: int) -> torch.Tensor:
    """table f32[M, C, N] (per-lane spectra) or f32[M, C] (rgb constants);
    mat_k i32[N] -> f32[C, N] selected rows.  A masked sum over the M rows,
    or one one-hot contraction past MAT_ROWS_CONTRACTION_THRESHOLD materials
    (the JAX package's two forms, integrator.py:375-400).  Exactly one term
    is nonzero per lane either way."""
    if n_materials > MAT_ROWS_CONTRACTION_THRESHOLD:
        oh = material_onehot(n_materials, mat_k)  # f32[M, N]
        if table.dim() == 2:
            return torch.einsum("mc,mn->cn", table, oh)
        return torch.einsum("mcn,mn->cn", table, oh)
    out = None
    for mi in range(n_materials):
        row = table[mi]
        if row.dim() == 1:
            row = row[:, None]
        term = torch.where((mat_k == mi)[None, :], row, 0.0)
        out = term if out is None else out + term
    return out


class LaneResult(NamedTuple):
    value: torch.Tensor  # f32[N, 3]: XYZ (spectral) or lRGB flux estimate
    alpha: torch.Tensor  # f32[N]: 1 where the camera ray hit anything


class BounceRecord(NamedTuple):
    """Per-bounce geometry-phase outputs consumed by the shading phase, one
    list entry of [N] per bounce."""

    mat: list  # i32: hit material id (0 where miss)
    tex_idx: list  # i32: flat texel index (0 when scene untextured)
    emit_w: list  # f32: 1 where this bounce's emission counts
    nee_w: list  # f32: n.l / pdf_light, 0 where NEE is gated off
    shad_mat: list  # i32: material hit by the shadow ray
    bsdf_w: list  # f32: n.l / pdf_bsdf (delta: 1), 0 where the path died


def _geometry_phase(scene: SceneData, cfg: RenderConfig, k_scan, ray_o: V3, ray_d: V3):
    """Phase 1: per bounce, closest hit, NEE visibility, BSDF direction.
    Runs for depth = 0 .. max_depth-2.  Returns (camera_hit bool[N],
    BounceRecord, final) where ``final`` is (emit_w, mat) of the final
    emission-only depth, or None when its gate is statically zero."""
    n = ray_o.x.shape[0]
    device = ray_o.x.device
    has_tex = scene.texture is not None
    zeros_i = torch.zeros((n,), dtype=torch.int32, device=device)

    def emission_gate(live_hit, depth):
        # reference src/renderer.cpp:167-175; with ELS, last_was_delta is
        # true only for the camera ray
        gate = live_hit & (depth == 0) if cfg.els else live_hit
        if cfg.indirect_only:
            gate = gate & (depth > 0)
        return gate

    o, d = ray_o, ray_d
    ignore = torch.full((n,), -1, dtype=torch.int32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    camera_hit = torch.zeros((n,), dtype=torch.bool, device=device)
    recs = BounceRecord([], [], [], [], [], [])
    for depth in range(cfg.max_depth - 1):
        kd = rnd.fold_in(k_scan, depth)
        k_nee, k_bsdf = rnd.split(kd)

        with span("ss.intersect"):
            rec = intersect_rays_dispatch(scene, o, d, ignore, cfg.eps, impl=cfg.intersect_impl)
        live_hit = alive & rec.hit
        if depth == 0:
            camera_hit = camera_hit | live_hit
        emit_w = emission_gate(live_hit, depth).to(torch.float32)
        hit_dist = torch.where(torch.isfinite(rec.dist), rec.dist, 0.0)
        hit_pos = o + d * hit_dist
        is_mirror = is_mirror_mask(scene, rec.mat)
        tex_idx = texel_index(scene, rec.st_s, rec.st_t) if has_tex else zeros_i

        # next-event estimation geometry (reference src/renderer.cpp:182-220)
        if cfg.els:
            shad_d, inv_pdf, light_prim = _sample_light_dir(k_nee, scene, hit_pos)
            n_dot_l = dot(shad_d, rec.normal)
            nee_gate = live_hit & (n_dot_l > 0.0)
            if cfg.indirect_only:
                nee_gate = nee_gate & (depth > 0)
            with span("ss.intersect"):
                shad_rec = intersect_rays_dispatch(
                    scene, hit_pos, shad_d, rec.prim, cfg.eps, need_attrs=False, impl=cfg.intersect_impl
                )
            nee_gate = nee_gate & (shad_rec.prim == light_prim)
            nee_w = torch.where(nee_gate, n_dot_l * inv_pdf, 0.0)
            shad_mat = shad_rec.mat
        else:
            nee_w = torch.zeros((n,), dtype=torch.float32, device=device)
            shad_mat = zeros_i

        # BSDF direction sample (reference src/renderer.cpp:222-250): only
        # the material type picks the sampler, never the albedo value
        w_i, pdf, is_delta = sample_bsdf_direction(k_bsdf, cfg, is_mirror, -d, rec.normal)
        n_dot_l_b = dot(w_i, rec.normal)
        # delta convention: n.l := 1, pdf := 1 (reference src/renderer.cpp:234-243)
        n_dot_l_b = torch.where(is_delta, 1.0, n_dot_l_b)
        pdf = torch.where(is_delta, 1.0, pdf)
        cont = live_hit & (n_dot_l_b > 0.0)
        bsdf_w = torch.where(cont, n_dot_l_b / torch.where(pdf > 0.0, pdf, 1.0), 0.0)

        o = v3where(cont, hit_pos, o)
        d = v3where(cont, w_i, d)
        ignore = torch.where(cont, rec.prim, ignore)
        alive = cont
        for field, val in zip(recs, (rec.mat, tex_idx, emit_w, nee_w, shad_mat, bsdf_w)):
            field.append(val)

    final = None
    # Final depth: emission only.  With ELS on, its emission gate is
    # statically zero whenever max_depth > 1, so the whole final sweep is
    # skipped (the JAX package's final-dead rule).
    if not (cfg.els and cfg.max_depth > 1):
        with span("ss.intersect"):
            rec = intersect_rays_dispatch(scene, o, d, ignore, cfg.eps, need_attrs=False, impl=cfg.intersect_impl)
        live_hit = alive & rec.hit
        if cfg.max_depth == 1:
            camera_hit = camera_hit | live_hit
        final = (emission_gate(live_hit, cfg.max_depth - 1).to(torch.float32), rec.mat)
    return camera_hit, recs, final


def _shading_phase(scene: SceneData, tables: ColorTables, cfg: RenderConfig, recs: BounceRecord, final, lam0,
                   ray_d: V3) -> torch.Tensor:
    """Phase 2: the material spectra, the throughput/radiance chain over
    the bounces of ``recs`` (and ``final``'s emission), the flat-field term
    and the XYZ estimator; returns the value f32[3, N]."""
    n = lam0.shape[0]
    device = lam0.device
    s_dim = cfg.n_wavelengths if cfg.spectral else 3

    # material spectra depend on lam0 only: evaluated once, reused per bounce.
    # With cfg.remat_cache the backward recomputes them instead of keeping the
    # hat-weight intermediates that link the material tables to the lanes
    # (the JAX package's jax.checkpoint, integrator.py:203-211).
    if cfg.remat_cache and torch.is_grad_enabled():
        cache = checkpoint(precompute_constant_spectra, scene, cfg, lam0, use_reentrant=False)
    else:
        cache = precompute_constant_spectra(scene, cfg, lam0)
    has_tex = scene.texture is not None
    if cfg.spectral and cfg.mode == "mallett" and has_tex:
        cache["basis_hero"] = precompute_basis_hero(tables, cfg, lam0)

    m = scene.materials
    n_bounces = cfg.max_depth - 1

    emit_table = cache["emission"] if cfg.spectral else m.emission_rgb
    alb_table = cache["albedo"] if cfg.spectral else m.albedo_rgb

    # one merged texel fetch for all bounces (the JAX package's merged fetch)
    merged_rows = None
    if has_tex and n_bounces > 0:
        fetched = scene.texture[torch.cat(recs.tex_idx).to(torch.int64)]
        merged_rows = [fetched[k * n:(k + 1) * n] for k in range(n_bounces)]

    def albedo_of(k):
        const = _mat_rows(alb_table, recs.mat[k], m.n_materials)
        if not has_tex:
            return const
        texv = texture_albedo_deferred(scene, tables, cfg, cache, recs.tex_idx[k], lam0,
                                       texel_rows=merged_rows[k])
        # the texture is not a differentiable leaf
        texv = texv.detach()
        is_tex = is_textured_mask(scene, recs.mat[k])
        return torch.where(is_tex[None, :], texv, const)

    # the accumulation chain runs per wavelength on [N] tensors
    beta = [torch.ones((n,), dtype=torch.float32, device=device) for _ in range(s_dim)]
    radiance = [torch.zeros((n,), dtype=torch.float32, device=device) for _ in range(s_dim)]
    for k in range(n_bounces):
        emit = _mat_rows(emit_table, recs.mat[k], m.n_materials)
        albedo = albedo_of(k)
        mirror = is_mirror_mask(scene, recs.mat[k])
        light_emit = _mat_rows(emit_table, recs.shad_mat[k], m.n_materials) if cfg.els else None
        for s in range(s_dim):
            radiance[s] = radiance[s] + (beta[s] * recs.emit_w[k]) * emit[s]
            if cfg.els:
                # f_s toward the light: Lambertian albedo/pi; a mirror's
                # delta BRDF cannot be hit by NEE (src/material.cpp:146-152)
                f_s_nee = torch.where(mirror, 0.0, albedo[s] * (1.0 / PI))
                radiance[s] = radiance[s] + beta[s] * f_s_nee * light_emit[s] * recs.nee_w[k]
            # throughput: f_s = albedo (mirror) | albedo/pi (Lambertian),
            # times n.l/pdf (delta convention folded into bsdf_w)
            f_fac = torch.where(mirror, albedo[s], albedo[s] * (1.0 / PI))
            beta[s] = beta[s] * f_fac * recs.bsdf_w[k]
    if final is not None:
        final_emit_w, final_mat = final
        emit = _mat_rows(emit_table, final_mat, m.n_materials)
        for s in range(s_dim):
            radiance[s] = radiance[s] + (beta[s] * final_emit_w) * emit[s]

    # flat-field correction (reference src/renderer.cpp:262-266)
    if not cfg.flat_field:
        cosw = dot(ray_d, splat(scene.camera.forward, ray_d.x))
        radiance = [r * cosw for r in radiance]
    flux = torch.stack(radiance)
    if not cfg.spectral:
        return flux
    return specradflux_to_ciexyz_hero_soa(tables, flux, lam0, cfg.n_wavelengths, cfg.lambda_step,
                                          lambda_min=cfg.lambda_min)


def trace_lanes(scene: SceneData, tables: ColorTables, cfg: RenderConfig, key, px_i: torch.Tensor,
                px_j: torch.Tensor) -> LaneResult:
    """Trace one sample for each lane; px_i/px_j: i32[N] pixel coordinates
    (reference ``Renderer::_render_sample``, src/renderer.cpp:104-276)."""
    n = px_i.shape[0]
    device = px_i.device
    k_cam, k_lam, k_scan = rnd.split(key, 3)

    with torch.no_grad():
        ray_o, ray_d = camera_rays_soa(scene, cfg, k_cam, px_i, px_j)
        if cfg.spectral:
            lam0 = cfg.lambda_min + uniform(k_lam, (n,), device) * cfg.lambda_step
        else:
            lam0 = torch.zeros((n,), dtype=torch.float32, device=device)
        camera_hit, recs, final = _geometry_phase(scene, cfg, k_scan, ray_o, ray_d)

    with span("ss.shading"):
        value = _shading_phase(scene, tables, cfg, recs, final, lam0, ray_d)
    return LaneResult(value=value.T, alpha=camera_hit.to(torch.float32))
