"""Meng et al. 2015 spectral upsampling ("meng" mode; frozen from the
renderer's ``spectra.upsample_meng``).

The paper's published grid interpolation (reference
src/meng-et-al.-2015/spectrum_grid.h:13-137) as branchless lane math:
XYZ -> xy chromaticity -> rotated uv grid coordinate -> either bilinear
interpolation (inner cells) or a masked triangle-fan barycentric search
(boundary cells, <= 6 vertices per cell), factored into per-lane point
weights.  The grid is read in place from the JAX package's data folder
(meng2015-grid.npz), in float32.

lRGB reaches XYZ through Meng's own legacy matrix scaled by 100 (reference
src/util/color.cpp:174-201).  The spectral lookup clamps to the table's
edge bins (the shading's hero reconstruction pads with the last bin), so
the mode runs under the CIE 2006 observer too although the data stop at
780 nm (the reference refuses that pairing at compile time,
src/stdafx.hpp:107-109).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.colorimetry import MENG_M_RGB_TO_XYZ
from benchmark.reference.spectrum import data_path

FLT_MAX = 3.4028235e38


@functools.lru_cache(maxsize=1)
def meng_grid_meta():
    """(lam_min, lam_max, n_samples) of the grid's spectra: dataset
    constants (380-780 nm at 5 nm) that fix the static window geometry of
    the shading's hero reconstruction (shading.py)."""
    z = np.load(data_path("meng2015-grid.npz"))
    return float(z["lam_min"]), float(z["lam_max"]), int(z["pts_spectrum"].shape[1])


def load_meng_tables(device="cpu", dtype=torch.float32) -> dict:
    """The grid as tensors on ``device``, plus its static metadata as plain
    Python numbers.  ``cell_chan`` [C, 20] holds every cell-indexed value
    the walk reads (inside, num, 6 point ids, 6 u, 6 v); the point ids are
    small integers, exact in f32."""
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
    6 u f32[N], 6 v f32[N])."""
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


def meng_cell_weights_soa(meng: dict, x, y, z):
    """The grid evaluation factored into per-position point weights:
    (pidx i32[6, N], w f32[6, N]) with the spectrum at XYZ equal to
    ``sum_slot w[slot] * spectrum(pidx[slot], lam)`` for every wavelength
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


def lrgb_to_xyz_meng(r, g, b):
    """lRGB -> XYZ through Meng's matrix x100 (reference
    src/util/color.cpp:174-201)."""
    m = [[float(v) for v in row] for row in MENG_M_RGB_TO_XYZ]
    x = (m[0][0] * r + m[0][1] * g + m[0][2] * b) * 100.0
    y = (m[1][0] * r + m[1][1] * g + m[1][2] * b) * 100.0
    z = (m[2][0] * r + m[2][1] * g + m[2][2] * b) * 100.0
    return x, y, z
