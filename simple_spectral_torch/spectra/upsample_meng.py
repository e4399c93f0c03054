"""Meng et al. 2015 spectral upsampling ("meng" mode; PyTorch port of
``simple_spectral_tpu.spectra.upsample_meng``).

The paper's published grid interpolation (reference
src/meng-et-al.-2015/spectrum_grid.h:13-137) as branchless lane math:
XYZ -> xy chromaticity -> rotated uv grid coordinate -> either bilinear
interpolation (inner cells) or a masked triangle-fan barycentric search
(boundary cells, <= 6 vertices per cell).  The grid is read in place from
the JAX package's data folder (meng2015-grid.npz).

lRGB reaches XYZ through Meng's own legacy matrix scaled by 100 (reference
src/util/color.cpp:174-201).  Like the JAX package, the spectral lookup
clamps to the table's edge bins, so the mode runs under the CIE 2006
observer too although the data stops at 780 nm (the reference refuses that
pairing at compile time, src/stdafx.hpp:107-109).

The shading's textured albedo, from a texel to its hero reflectances, is
:func:`meng_albedo_hero`: on a CUDA device one launch of kernel M1
(``csrc/meng_albedo.cu``: sRGB decode, the grid walk and the hero sum of the
six (point, weight) slots, built and loaded like K1); on the CPU its plain
twin :func:`meng_albedo_hero_plain`, which runs M1's FP32 operations in
M1's order.  The card tests hold the two equal bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import types

import numpy as np
import torch

from simple_spectral_torch import kernels
from simple_spectral_torch.spectra.colorimetry import MENG_M_RGB_TO_XYZ, srgb_to_lrgb
from simple_spectral_torch.spectra.spectrum import data_path, hero_lams_soa

FLT_MAX = 3.4028235e38

# Launches of kernel M1, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("meng_albedo.cu")
# meng_albedo_launch(format, texels, lam0, out, n, n_hero, hero_step, spec, n_pts, n_bins, lam_min, lam_span,
#                    cells, n_cells, width, height, u_hi, v_hi, uv, lut, m, stream)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
             + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4)
# the kernel's texel formats, and the slots a "rows" texel holds
FORMATS = {"u32": 0, "rows": 1}
SLOTS = 6
# the kernel strides over the lanes with int32 indices
MAX_LANES = 1 << 30
# Meng's matrix as the kernel takes it, float32 row major
_M_F32 = (ctypes.c_float * 9)(*(float(v) for row in MENG_M_RGB_TO_XYZ for v in row))


def load_meng_tables(device="cpu", dtype=torch.float32) -> dict:
    """The grid as tensors on ``device``, plus its static metadata as plain
    Python numbers.  ``cell_chan`` [C, 20] holds every cell-indexed value
    the device walk reads (inside, num, 6 point ids, 6 u, 6 v); the point
    ids are small integers, exact in f32."""
    z = np.load(data_path("meng2015-grid.npz"))
    gi = np.maximum(np.asarray(z["grid_idx"], np.int64), 0)  # [C, 6]
    pu = np.asarray(z["pts_uv"])[gi, 0]
    pv = np.asarray(z["pts_uv"])[gi, 1]
    cell_chan = np.concatenate(
        [
            np.asarray(z["grid_inside"], np.float64)[:, None],
            np.asarray(z["grid_num"], np.float64)[:, None],
            gi.astype(np.float64),
            pu,
            pv,
        ],
        axis=1,
    )

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return {
        "mat_xy_to_uv": dev(z["mat_xy_to_uv"]),  # [6]
        "grid_inside": dev(z["grid_inside"], torch.int32),  # [W*H]
        "grid_num": dev(z["grid_num"], torch.int32),  # [W*H]
        "grid_idx": dev(z["grid_idx"], torch.int32),  # [W*H, 6]
        "pts_uv": dev(z["pts_uv"]),  # [P, 2]
        "pts_spectrum": dev(z["pts_spectrum"]),  # [P, K]
        "cell_chan": dev(cell_chan),  # [W*H, 20]
        "width": int(z["width"]),
        "height": int(z["height"]),
        "lam_min": float(z["lam_min"]),
        "lam_max": float(z["lam_max"]),
    }


def _uv_position(meng: dict, x, y, z):
    """XYZ -> grid-uv position (grid.h:24-45): returns (u_safe, v_safe, ui,
    vi, cell, valid, ssum)."""
    w_grid = meng["width"]
    h_grid = meng["height"]
    ssum = x + y + z
    norm = 1.0 / ssum
    # C: if (!(norm < FLT_MAX)) return 0 -- catches +inf and NaN
    valid = norm < FLT_MAX
    xy_x = x * norm
    xy_y = y * norm
    m = meng["mat_xy_to_uv"]
    u = m[0] * xy_x + m[1] * xy_y + m[2]
    v = m[3] * xy_x + m[4] * xy_y + m[5]
    valid = valid & (u >= 0.0) & (u < w_grid) & (v >= 0.0) & (v < h_grid)
    u_safe = torch.clamp(torch.where(valid, u, 0.0), 0.0, w_grid - 1e-4)
    v_safe = torch.clamp(torch.where(valid, v, 0.0), 0.0, h_grid - 1e-4)
    ui = torch.floor(u_safe).to(torch.int32)
    vi = torch.floor(v_safe).to(torch.int32)
    cell = ui + w_grid * vi
    return u_safe, v_safe, ui, vi, cell, valid, ssum


def _cell_values(meng: dict, cell):
    """The cell-indexed values of the lanes' cells, from one row of
    ``cell_chan`` each: (inside i32[N], num i32[N], 6 point ids i32[N],
    6 u f32[N], 6 v f32[N]).  The JAX package's u32 walk reads that row
    with a one-hot contraction over the cells at full precision, which has
    exactly one non-zero term per lane; the row index returns the same
    values bit for bit, as does reading the tables one by one."""
    chans = meng["cell_chan"][cell.to(torch.int64)].T  # [20, N]
    return (chans[0].to(torch.int32), chans[1].to(torch.int32), [chans[2 + s].to(torch.int32) for s in range(6)],
            [chans[8 + s] for s in range(6)], [chans[14 + s] for s in range(6)])


def _fan_triangles(u_safe, v_safe, num, pu_slots, pv_slots):
    """The boundary cells' barycentric search over the triangle fan around
    slot 0 (grid.h:91-131).  Yields, for fan triangle i = 0 .. 4, (take,
    closing, nxt, bu, bv, bw): ``take`` marks the lanes whose position lies
    in this triangle and in none before it; the triangle's vertices are
    slots 0, min(i + 1, 5) and (closing ? 1 : nxt), weighted bw, bv, bu."""
    ex = u_safe - pu_slots[0]
    ey = v_safe - pv_slots[0]
    e_x = [pu_slots[s] - pu_slots[0] for s in range(6)]
    e_y = [pv_slots[s] - pv_slots[0] for s in range(6)]
    e0x, e0y = e_x[1], e_y[1]
    uu = e0x * ey - ex * e0y
    found = torch.zeros(ex.shape, dtype=torch.bool, device=ex.device)
    for i in range(5):  # i = 0 .. num-2, num <= 6
        closing = num == (i + 2)
        nxt = min(i + 2, 5)
        e1x = torch.where(closing, e_x[1], e_x[nxt])
        e1y = torch.where(closing, e_y[1], e_y[nxt])
        vv = ex * e1y - e1x * ey
        area = e0x * e1y - e1x * e0y
        area_ok = area != 0.0
        inv_area = torch.where(area_ok, 1.0 / torch.where(area_ok, area, 1.0), 0.0)
        bu = uu * inv_area
        bv = vv * inv_area
        bw = 1.0 - bu - bv
        in_tri = (bu >= 0.0) & (bv >= 0.0) & (bw >= 0.0) & (num - 1 > i)
        take = in_tri & ~found
        yield take, closing, nxt, bu, bv, bw
        found = found | take
        # not accepted: advance the fan edge (grid.h:120-124)
        uu = torch.where(take, uu, -vv)
        e0x = torch.where(take, e0x, e1x)
        e0y = torch.where(take, e0y, e1y)


def spectrum_xyz_to_p_soa(meng: dict, x, y, z, lams):
    """The grid evaluation: per-lane XYZ (f32[N] x3) and wavelengths
    f32[S, N] -> spectral power f32[S, N] (reference
    src/meng-et-al.-2015/spectrum_grid.h:13-137)."""
    u_safe, v_safe, ui, vi, cell, valid, ssum = _uv_position(meng, x, y, z)
    inside, num, pidx_slots, pu_slots, pv_slots = _cell_values(meng, cell)

    spec = meng["pts_spectrum"]
    n_samples = spec.shape[1]
    spec_flat = spec.reshape(-1)

    # wavelength bin, clamped to the table (the CIE 2006 extension)
    sb = (lams - meng["lam_min"]) / (meng["lam_max"] - meng["lam_min"]) * (n_samples - 1)
    sb = torch.clamp(sb, 0.0, n_samples - 1)
    sb0 = torch.floor(sb).to(torch.int64)
    sb1 = torch.clamp_max(sb0 + 1, n_samples - 1)
    sbf = sb - sb0.to(torch.float32)

    p_slots = []
    for pidx in pidx_slots:
        base = pidx.to(torch.int64) * n_samples
        p0 = spec_flat[base[None, :] + sb0]
        p1 = spec_flat[base[None, :] + sb1]
        p_slots.append(p0 * (1.0 - sbf) + p1 * sbf)  # [S, N]

    # inner cells: bilinear over the 2x2 quad (grid.h:75-89; vertex layout 2 3 / 0 1)
    fu = u_safe - ui.to(torch.float32)
    fv = v_safe - vi.to(torch.float32)
    p_in = (
        p_slots[0] * (1.0 - fu) * (1.0 - fv)
        + p_slots[2] * (1.0 - fu) * fv
        + p_slots[3] * fu * fv
        + p_slots[1] * fu * (1.0 - fv)
    )

    # boundary cells: value = p[0]*bw + p[i+1]*bv + p[closing ? 1 : nxt]*bu (grid.h:112-118)
    p_fan = torch.zeros_like(p_in)
    for i, (take, closing, nxt, bu, bv, bw) in enumerate(_fan_triangles(u_safe, v_safe, num, pu_slots, pv_slots)):
        p_c = torch.where(closing[None, :], p_slots[1], p_slots[nxt])
        tri_val = p_slots[0] * bw + p_slots[min(i + 1, 5)] * bv + p_c * bu
        p_fan = torch.where(take[None, :], tri_val, p_fan)

    p = torch.where(inside[None, :] > 0, p_in, p_fan)
    ok = valid & (num > 0)
    # p / norm == p * (X+Y+Z) (grid.h:134-136)
    return torch.where(ok[None, :], p * ssum[None, :], 0.0)


def meng_cell_weights_soa(meng: dict, x, y, z):
    """The grid evaluation factored into per-position point weights:
    (pidx i32[6, N], w f32[6, N]) with ``spectrum_xyz_to_p(lam, xyz) ==
    sum_slot w[slot] * spectrum(pidx[slot], lam)`` for every wavelength
    (the interpolation weights depend only on the chromaticity position).
    The 1/norm scale is folded into w."""
    u_safe, v_safe, ui, vi, cell, valid, ssum = _uv_position(meng, x, y, z)
    inside, num, pidx_slots, pu_slots, pv_slots = _cell_values(meng, cell)

    # inner-cell bilinear weights (vertex layout 2 3 / 0 1, grid.h:75-89)
    fu = u_safe - ui.to(torch.float32)
    fv = v_safe - vi.to(torch.float32)
    zeros = torch.zeros_like(fu)
    w_in = [(1.0 - fu) * (1.0 - fv), fu * (1.0 - fv), (1.0 - fu) * fv, fu * fv, zeros, zeros]

    # boundary cells: the fan triangle's barycentrics on its three slots
    w_fan = [zeros for _ in range(6)]
    for i, (t, closing, nxt, bu, bv, bw) in enumerate(_fan_triangles(u_safe, v_safe, num, pu_slots, pv_slots)):
        w_fan[0] = torch.where(t, w_fan[0] + bw, w_fan[0])
        bslot = min(i + 1, 5)
        w_fan[bslot] = torch.where(t, w_fan[bslot] + bv, w_fan[bslot])
        # the third vertex is slot 1 on the closing triangle, else slot nxt (>= 2)
        w_fan[1] = torch.where(t & closing, w_fan[1] + bu, w_fan[1])
        w_fan[nxt] = torch.where(t & ~closing, w_fan[nxt] + bu, w_fan[nxt])

    ok = valid & (num > 0)
    scale = torch.where(ok, ssum, 0.0)  # p / norm == p * (X+Y+Z)
    w_out = [torch.where(inside > 0, w_in[s], w_fan[s]) * scale for s in range(6)]
    return torch.stack(pidx_slots), torch.stack(w_out)


# The JAX package's second walk (the one its u32 shading runs) differs from
# the first only in reading the cell's values by a one-hot contraction, to
# avoid gathers on the TPU; here both read the cell's row.
meng_cell_weights_soa_onehot = meng_cell_weights_soa


def lrgb_to_xyz_meng(r, g, b):
    """lRGB -> XYZ through Meng's matrix x100 (reference
    src/util/color.cpp:174-201)."""
    m = [[float(v) for v in row] for row in MENG_M_RGB_TO_XYZ]
    x = (m[0][0] * r + m[0][1] * g + m[0][2] * b) * 100.0
    y = (m[1][0] * r + m[1][1] * g + m[1][2] * b) * 100.0
    z = (m[2][0] * r + m[2][1] * g + m[2][2] * b) * 100.0
    return x, y, z


def lrgb_to_specrefl_meng_soa(tables, cfg, r, g, b, lam0) -> torch.Tensor:
    """lRGB -> hero reflectance via Meng's matrix x100 then the grid
    (reference src/util/color.cpp:174-201) -> f32[S, N]."""
    x, y, z = lrgb_to_xyz_meng(r, g, b)
    lams = hero_lams_soa(lam0, cfg.n_wavelengths, cfg.lambda_step)
    return spectrum_xyz_to_p_soa(tables.meng, x, y, z, lams)


def lrgb_to_specrefl_meng(tables, lrgb: torch.Tensor, lambda_0: torch.Tensor, n_wavelengths: int,
                          lambda_step: float) -> torch.Tensor:
    """Row layout: lrgb f32[..., 3], lambda_0 f32[...] -> f32[..., S]."""
    shape = tuple(lambda_0.shape)
    cfg = types.SimpleNamespace(n_wavelengths=n_wavelengths, lambda_step=lambda_step)
    out = lrgb_to_specrefl_meng_soa(tables, cfg, lrgb[..., 0].reshape(-1), lrgb[..., 1].reshape(-1),
                                    lrgb[..., 2].reshape(-1), lambda_0.reshape(-1))
    return torch.movedim(out, 0, -1).reshape(shape + (n_wavelengths,))


@functools.lru_cache(maxsize=None)
def srgb_decode_table(device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """f32[256]: ``srgb_to_lrgb`` of each 8-bit sRGB code, as
    ``shading.texel_fetch_lrgb`` decodes a channel (code x 1/255, then the
    curve), computed once on the CPU with the plain function and copied to
    ``device``, so that M1 and its twin decode alike."""
    if torch.device(device).type != "cpu":
        return srgb_decode_table(torch.device("cpu")).to(device)
    return srgb_to_lrgb(torch.arange(256, dtype=torch.float32) * (1.0 / 255.0))


def _check_inputs(meng: dict, texel_format: str, texels: torch.Tensor, lam0: torch.Tensor) -> int:
    """The lane count; raises on a texel format, dtype, shape, device or
    layout the kernel cannot read."""
    if texel_format not in FORMATS:
        raise ValueError(f"unsupported meng texel format {texel_format!r}")
    if lam0.dtype != torch.float32 or lam0.dim() != 1 or not lam0.is_contiguous():
        raise ValueError(f"lam0 must be contiguous f32[N], got {lam0.dtype} {tuple(lam0.shape)}")
    n = lam0.shape[0]
    want = ((n,), torch.int32) if texel_format == "u32" else ((n, 2 * SLOTS), torch.float32)
    if tuple(texels.shape) != want[0] or texels.dtype != want[1] or not texels.is_contiguous():
        raise ValueError(f"{texel_format} texels must be contiguous {want[1]} {want[0]}, got "
                         f"{texels.dtype} {tuple(texels.shape)}")
    for name in ("pts_spectrum", "cell_chan", "mat_xy_to_uv"):
        t = meng[name]
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != lam0.device:
            raise ValueError(f"meng table {name} must be contiguous f32 on {lam0.device}")
    if texels.device != lam0.device:
        raise ValueError(f"texels on {texels.device}, lam0 on {lam0.device}")
    if n > MAX_LANES:
        raise ValueError(f"{n} lanes: the kernel takes at most {MAX_LANES}")
    return n


def _hero_sum(meng: dict, pidx: torch.Tensor, w: torch.Tensor, lam0: torch.Tensor, n_wavelengths: int,
              lambda_step: float) -> torch.Tensor:
    """sum over the six slots, in slot order, of w x the slot's point
    spectrum at each hero wavelength, read as ``spectrum_xyz_to_p_soa``
    reads it: the bin and its fraction clamped to the table's edges, a lerp
    between the two bins -> f32[S, N]."""
    spec = meng["pts_spectrum"]
    n_bins = spec.shape[1]
    spec_flat = spec.reshape(-1)
    lams = hero_lams_soa(lam0, n_wavelengths, lambda_step)
    sb = (lams - meng["lam_min"]) / (meng["lam_max"] - meng["lam_min"]) * (n_bins - 1)
    sb = torch.clamp(sb, 0.0, n_bins - 1)
    sb0 = torch.floor(sb).to(torch.int64)
    sb1 = torch.clamp_max(sb0 + 1, n_bins - 1)
    sbf = sb - sb0.to(torch.float32)
    acc = None
    for slot in range(SLOTS):
        base = pidx[slot].to(torch.int64)[None, :] * n_bins
        term = w[slot][None, :] * (spec_flat[base + sb0] * (1.0 - sbf) + spec_flat[base + sb1] * sbf)
        acc = term if acc is None else acc + term
    return acc


def meng_albedo_hero_plain(meng: dict, texel_format: str, texels: torch.Tensor, lam0: torch.Tensor,
                           n_wavelengths: int, lambda_step: float) -> torch.Tensor:
    """Plain twin of M1 -> f32[S, N]: "u32" packed sRGB words i32[N] through
    the decode table, Meng's matrix x100 and the walk of
    :func:`meng_cell_weights_soa`; "rows" the walk's six point ids and
    weights f32[N, 12]; then :func:`_hero_sum`."""
    _check_inputs(meng, texel_format, texels, lam0)
    if texel_format == "u32":
        lut = srgb_decode_table(texels.device)
        r, g, b = (lut[((texels >> shift) & 0xFF).to(torch.int64)] for shift in (16, 8, 0))
        pidx, w = meng_cell_weights_soa(meng, *lrgb_to_xyz_meng(r, g, b))
    else:
        pidx, w = texels[:, :SLOTS].T.to(torch.int32), texels[:, SLOTS:].T
    return _hero_sum(meng, pidx, w, lam0, n_wavelengths, lambda_step)


def meng_albedo_hero_cuda(meng: dict, texel_format: str, texels: torch.Tensor, lam0: torch.Tensor,
                          n_wavelengths: int, lambda_step: float) -> torch.Tensor:
    """Launch M1 once on the current stream -> f32[S, N].  Raises on a
    device that is not CUDA and on inputs the kernel cannot read, before
    allocating."""
    global LAUNCHES
    dev = lam0.device
    if dev.type != "cuda":
        raise ValueError(f"meng_albedo_hero_cuda needs CUDA tensors, got {dev}")
    n = _check_inputs(meng, texel_format, texels, lam0)
    if n_wavelengths < 1:
        raise ValueError(f"n_wavelengths must be >= 1, got {n_wavelengths}")
    out = torch.empty((n_wavelengths, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    spec, cells = meng["pts_spectrum"], meng["cell_chan"]
    width, height = meng["width"], meng["height"]
    lut = srgb_decode_table(dev)
    launch = kernels.load(SOURCE, "meng_albedo_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(FORMATS[texel_format], texels.data_ptr(), lam0.data_ptr(), out.data_ptr(), n, n_wavelengths,
                     lambda_step, spec.data_ptr(), spec.shape[0], spec.shape[1], meng["lam_min"],
                     meng["lam_max"] - meng["lam_min"], cells.data_ptr(), cells.shape[0], width, height,
                     width - 1e-4, height - 1e-4, meng["mat_xy_to_uv"].data_ptr(), lut.data_ptr(), _M_F32, stream)
    if err != 0:
        raise RuntimeError(f"meng albedo kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def meng_albedo_hero(meng: dict, texel_format: str, texels: torch.Tensor, lam0: torch.Tensor,
                     n_wavelengths: int, lambda_step: float) -> torch.Tensor:
    """Meng's textured albedo at the hero wavelengths ``lam0 + s *
    lambda_step``, f32[S, N], from the texels' packed sRGB words ("u32") or
    their precomputed (point ids, weights) rows ("rows"): M1 for CUDA
    tensors, its plain twin for CPU tensors."""
    if lam0.device.type == "cuda":
        return meng_albedo_hero_cuda(meng, texel_format, texels, lam0, n_wavelengths, lambda_step)
    if lam0.device.type == "cpu":
        return meng_albedo_hero_plain(meng, texel_format, texels, lam0, n_wavelengths, lambda_step)
    raise ValueError(f"no meng albedo for device {lam0.device}")
