"""Branchless material shading over a flat batch of hits (PyTorch port of
``simple_spectral_tpu.render.shading``; all four colour pipelines).

Per-lane spectra are ``f32[S, N]`` (hero wavelengths first, lanes last).
A per-lane linear-interp lookup of a per-material spectrum is written as a
hat-function contraction ``v[s,n] = sum_k row[k,n] * max(0, 1-|x[s,n]-k|)``:
linear reconstruction with the reference's zero-outside-range semantics
(reference src/spectrum.cpp:39-60).
"""

from __future__ import annotations

import math

import torch

from simple_spectral_torch.config import MODE_JAKOB, MODE_MALLETT, MODE_MENG, RenderConfig
from simple_spectral_torch.render import sampling
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.render.vec import where as v3where
from simple_spectral_torch.scene.types import BSDF_MIRROR, SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables, srgb_to_lrgb
from simple_spectral_torch.spectra.spectrum import hat_weights, hero_lams_soa
from simple_spectral_torch.spectra.upsample_jakob import jakob_q32_eval_soa, rgb2spec_eval_soa
from simple_spectral_torch.spectra.upsample_meng import lrgb_to_xyz_meng, meng_cell_weights_soa, meng_grid_meta
from simple_spectral_torch.utils.profiling import span

PI = 3.14159265358979323846

# Material-row selection switches from the O(M) masked sum to a one-hot
# contraction above this many materials (render/integrator.py _mat_rows).
MAT_ROWS_CONTRACTION_THRESHOLD = 12


def material_onehot(n_materials: int, mat: torch.Tensor) -> torch.Tensor:
    """i32[N] -> f32[M, N] one-hot."""
    iota = torch.arange(n_materials, dtype=mat.dtype, device=mat.device)[:, None]
    return (iota == mat[None, :]).to(torch.float32)


def select_column(column: torch.Tensor, mat: torch.Tensor, n_materials: int) -> torch.Tensor:
    """f32[M] or i32[M] at i32[N] -> [N] as a one-hot contraction.  Exactly
    one term is nonzero, so the f32 sum is exact."""
    oh = material_onehot(n_materials, mat)
    out = torch.einsum("m,mn->n", column.to(torch.float32), oh)
    return out.to(column.dtype)


def precompute_constant_spectra(scene: SceneData, cfg: RenderConfig, lam0: torch.Tensor):
    """Hero samples of every material's constant albedo/emission spectrum,
    evaluated once per camera sample (they depend on lam0 only) -> dict of
    f32[M, S, N] (spectral modes) or None entries (rgb mode)."""
    m = scene.materials
    if not cfg.spectral:
        return {"albedo": None, "emission": None}
    lams = hero_lams_soa(lam0, cfg.n_wavelengths, cfg.lambda_step)  # [S, N]

    def sample_all(values, low, inv_step):
        # per-material grids: K-dense hat pass with an M axis -> f32[M, S, N]
        x = (lams[None, :, :] - low[:, None, None]) * inv_step[:, None, None]
        w = hat_weights(x, values.shape[1])  # [K, M, S, N]
        return torch.sum(values.T[:, :, None, None] * w, dim=0)

    def sample_all_common(values, resample, grid):
        # shared lattice: resample each material onto it (exact), then one
        # shared hat-weight tensor and a contraction
        g_low, g_step, kc = grid
        res = torch.einsum("mk,mjk->mj", values, resample)
        # Hero wavelengths are lam0 + s*STEP; with STEP an integer multiple R
        # of the lattice pitch the S hat tensors are shifted copies of one
        # [K0 = R+3, N] window.
        s_dim = cfg.n_wavelengths
        r_ratio = cfg.lambda_step / g_step
        r_int = int(round(r_ratio))
        if abs(r_ratio - r_int) < 1e-9 and s_dim > 1:
            x0 = (lam0[None, :] - g_low) * (1.0 / g_step)  # [1, N]
            j0 = math.floor((cfg.lambda_min - g_low) / g_step) - 1
            k0 = r_int + 3
            if j0 >= 0 and j0 + k0 + (s_dim - 1) * r_int <= kc:
                w0 = hat_weights(x0 - j0, k0)[:, 0, :]  # [K0, N]
                res2 = torch.stack([res[:, j0 + s * r_int: j0 + s * r_int + k0] for s in range(s_dim)], dim=1)
                return torch.einsum("msk,kn->msn", res2, w0)
        xg = (lams - g_low) * (1.0 / g_step)  # [S, N]
        wg = hat_weights(xg, kc)  # [Kc, S, N]
        return torch.einsum("mj,jsn->msn", res, wg)

    if m.albedo_grid is not None:
        albedo = sample_all_common(m.albedo_values, m.albedo_resample, m.albedo_grid)
    else:
        albedo = sample_all(m.albedo_values, m.albedo_low, m.albedo_inv_step)
    if m.emission_grid is not None:
        emission = sample_all_common(m.emission_values, m.emission_resample, m.emission_grid)
    else:
        emission = sample_all(m.emission_values, m.emission_low, m.emission_inv_step)
    return {"albedo": albedo, "emission": emission}


def precompute_basis_hero(tables: ColorTables, cfg: RenderConfig, lam0: torch.Tensor) -> torch.Tensor:
    """Mallett-Yuksel r/g/b basis spectra at the hero wavelengths,
    f32[3, S, N]; the per-bounce texture upsample is then three
    multiply-adds per (wavelength, lane)."""
    lams = hero_lams_soa(lam0, cfg.n_wavelengths, cfg.lambda_step)
    x = (lams - tables.basis_low) * tables.basis_inv_step
    w = hat_weights(x, tables.basis_values.shape[1])  # [K, S, N]
    return torch.einsum("ck,ksn->csn", tables.basis_values, w)


def texel_index(scene: SceneData, st_s: torch.Tensor, st_t: torch.Tensor) -> torch.Tensor:
    """Clamped nearest-neighbour ST -> flat texel index with vertical flip
    (reference src/material.cpp:66-97)."""
    w, h = scene.tex_res
    i = torch.clamp(torch.floor(st_s * w).to(torch.int32), 0, w - 1)
    j = torch.clamp(torch.floor(h - st_t * h).to(torch.int32), 0, h - 1)
    return j * w + i


def texel_fetch_lrgb(scene: SceneData, tex_idx: torch.Tensor, texel_words=None):
    """Packed sRGB texels at flat indices -> linear RGB (r, g, b) f32[N]
    (reference src/material.cpp:45-64: sRGB u8 -> f32 -> srgb_to_lrgb).
    ``texel_words``: words already fetched by the merged per-trace fetch."""
    packed = texel_words if texel_words is not None else scene.texture[tex_idx.to(torch.int64)]
    scale = 1.0 / 255.0
    r = ((packed >> 16) & 0xFF).to(torch.float32) * scale
    g = ((packed >> 8) & 0xFF).to(torch.float32) * scale
    b = (packed & 0xFF).to(torch.float32) * scale
    return srgb_to_lrgb(r), srgb_to_lrgb(g), srgb_to_lrgb(b)


def texture_albedo_deferred(scene: SceneData, tables, cfg: RenderConfig, cache, tex_idx, lam0, texel_rows=None):
    """Per-bounce textured albedo for the shading phase: one texel fetch
    and dense math, per colour pipeline.

    - rgb:      packed-word fetch -> lRGB                        -> f32[3, N]
    - mallett:  packed-word fetch, refl = r R + g G + b B with the basis
                pre-sampled at the hero wavelengths               -> f32[S, N]
    - jakob:    "u32": q32-word fetch, dequantize, sigmoid eval;
                "rows": f32[T, 3] coefficient rows, sigmoid eval  -> f32[S, N]
    - meng:     "u32": packed-word fetch and the grid walk here;
                "rows": f32[T, 12] (point ids, weights) rows; then the
                contraction over the grid points and the hero
                reconstruction                                     -> f32[S, N]

    ``texel_rows``: the texels already fetched by the merged per-trace
    fetch (words [N] or rows [N, C]); without it the texels at ``tex_idx``
    are fetched here.
    """
    if not cfg.spectral:
        r, g, b = texel_fetch_lrgb(scene, tex_idx, texel_words=texel_rows)
        return torch.stack([r, g, b])
    if cfg.mode == MODE_MALLETT:
        r, g, b = texel_fetch_lrgb(scene, tex_idx, texel_words=texel_rows)
        bh = cache["basis_hero"]  # [3, S, N]
        return bh[0] * r[None, :] + bh[1] * g[None, :] + bh[2] * b[None, :]
    rows = texel_rows if texel_rows is not None else scene.texture[tex_idx.to(torch.int64)]
    if cfg.mode == MODE_JAKOB:
        if cfg.texel_format == "u32":
            return jakob_q32_eval_soa(rows, scene.texel_meta, lam0, cfg.n_wavelengths, cfg.lambda_step)
        # [N, 3] coefficients
        return rgb2spec_eval_soa(rows[:, 0], rows[:, 1], rows[:, 2],
                                 hero_lams_soa(lam0, cfg.n_wavelengths, cfg.lambda_step))
    if cfg.mode == MODE_MENG:
        with span("ss.meng"):
            return _meng_albedo(scene, tables, cfg, rows, lam0)
    raise ValueError(f"unsupported mode {cfg.mode!r}")


def _meng_albedo(scene: SceneData, tables, cfg: RenderConfig, rows: torch.Tensor, lam0: torch.Tensor):
    """Meng's textured albedo at the hero wavelengths, f32[S, N], from the
    texels' packed sRGB words ("u32": the grid walk runs here) or their
    precomputed (point ids, weights) rows ("rows").  Its caller holds the
    whole of it (walk, point weights, contraction, hero reconstruction) in
    the ``ss.meng`` span, once per bounce."""
    if cfg.texel_format == "u32":
        r, g, b = texel_fetch_lrgb(scene, None, texel_words=rows)
        pidx_arr, w_arr = meng_cell_weights_soa(tables.meng, *lrgb_to_xyz_meng(r, g, b))  # [6, N]
        pidx_slots = [pidx_arr[s] for s in range(6)]
        w_slots = [w_arr[s] for s in range(6)]
    else:  # [N, 12]
        pidx_slots = [rows[:, s].to(torch.int32) for s in range(6)]
        w_slots = [rows[:, 6 + s] for s in range(6)]
    meng = tables.meng
    spec = meng["pts_spectrum"]  # [P, K]
    n_pts, k_dim = spec.shape
    n = rows.shape[0]
    # omega[p, n] = sum_slot w[slot][n] * [pidx[slot][n] == p]
    iota_p = torch.arange(n_pts, dtype=torch.int32, device=rows.device)[:, None]
    omega = torch.zeros((n_pts, n), dtype=torch.float32, device=rows.device)
    for slot in range(6):
        omega = omega + torch.where(iota_p == pidx_slots[slot][None, :], w_slots[slot][None, :], 0.0)
    q = torch.einsum("pk,pn->kn", spec, omega)  # [K, N]
    # Hero reconstruction: linear interpolation over the K 5-nm bins,
    # clamped to the table's edges.  When LAMBDA_STEP is an integer number R
    # of bins (both observers: 100/5, 110/5), hat(x_s - j) = hat(x_0 - (j -
    # sR)): one [R+2, N] weight window serves all S wavelengths against S
    # static row slices of q; padding q with its last row past the table is
    # the edge clamp.  The window geometry comes from the dataset's constants.
    g_lam_min, g_lam_max, k_meta = meng_grid_meta()
    if k_dim != k_meta:
        raise ValueError("meng tables and grid metadata disagree")
    bin_w = (g_lam_max - g_lam_min) / (k_dim - 1)
    r_ratio = cfg.lambda_step / bin_w
    r_int = int(round(r_ratio))
    s_dim = cfg.n_wavelengths
    j0 = math.floor((cfg.lambda_min - g_lam_min) / bin_w)
    if abs(r_ratio - r_int) < 1e-9 and j0 >= 0:
        w_width = r_int + 2
        k_need = j0 + w_width + (s_dim - 1) * r_int
        if k_need > k_dim:
            q = torch.cat([q, q[-1:].expand(k_need - k_dim, n)], dim=0)
        xw = (lam0 - g_lam_min) * (1.0 / bin_w) - j0  # f32[N], in [0, W-1)
        wins = [torch.clamp_min(1.0 - torch.abs(xw - j), 0.0) for j in range(w_width)]
        outs = []
        for s in range(s_dim):
            base = j0 + s * r_int
            acc = q[base] * wins[0]
            for j in range(1, w_width):
                acc = acc + q[base + j] * wins[j]
            outs.append(acc)
        return torch.stack(outs)
    # a non-integer bin ratio: the dense hat contraction
    lams = hero_lams_soa(lam0, cfg.n_wavelengths, cfg.lambda_step)
    x = (lams - meng["lam_min"]) / (meng["lam_max"] - meng["lam_min"]) * (k_dim - 1)
    x = torch.clamp(x, 0.0, k_dim - 1)
    wk = hat_weights(x, k_dim)  # [K, S, N]
    return torch.sum(q[:, None, :] * wk, dim=0)


def is_mirror_mask(scene: SceneData, mat: torch.Tensor) -> torch.Tensor:
    bt = select_column(scene.materials.bsdf_type.to(torch.float32), mat, scene.materials.n_materials)
    return bt == float(BSDF_MIRROR)


def is_textured_mask(scene: SceneData, mat: torch.Tensor) -> torch.Tensor:
    """True for lanes whose hit material takes its albedo from the texture."""
    kind = select_column(scene.materials.albedo_kind.to(torch.float32), mat, scene.materials.n_materials)
    return kind > 0.5


def sample_bsdf_direction(key, cfg: RenderConfig, is_mirror: torch.Tensor, w_o: V3, normal: V3):
    """Sample only the BSDF direction: cosine hemisphere for Lambertian
    (reference src/material.cpp:130-143), reflection with a delta pdf for
    mirrors (src/material.cpp:154-167).  Returns (w_i V3[N], pdf f32[N],
    is_delta bool[N]); the delta pdf is +inf, the reference's sentinel."""
    local, pdf_lam = sampling.rand_coshemi(key, tuple(is_mirror.shape), cfg.eps, is_mirror.device)
    w_i_lam = sampling.rotated_to(local, normal)
    w_i_mir = sampling.reflect(w_o, normal)
    w_i = v3where(is_mirror, w_i_mir, w_i_lam)
    pdf = torch.where(is_mirror, float("inf"), pdf_lam)
    return w_i, pdf, is_mirror
