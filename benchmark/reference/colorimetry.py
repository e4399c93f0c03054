"""Colorimetry: CIE tables, D65, RGB<->XYZ matrices, conversions (frozen from the renderer's
``spectra.colorimetry``).

``Color::init`` (reference src/util/color.cpp:72-155) becomes
:func:`build_color_tables`, a host-side float64 computation producing a
:class:`ColorTables` of device tensors; every hot-path conversion is a plain
torch function over those tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.config import MODE_JAKOB, MODE_MALLETT, RenderConfig
from benchmark.reference.spectrum import (
    Spectrum,
    hat_weights,
    hero_lams_soa,
    load_spectral_csv,
)

# Physical constants (reference src/stdafx.hpp:192-210).
K_B = 1.38064852e-23  # Boltzmann (J/K)
H = 6.62607015e-34  # Planck (J*s)
C = 299_792_458.0  # speed of light (m/s)

# BT.709 primaries (reference src/util/color.cpp:150).
BT709_XY = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]], dtype=np.float64)

_OBS_FILES = {
    1931: ("cie1931-xyzbar-380+5+780.csv", 380.0, 780.0),
    2006: ("cie2006-xyzbar-390+1+830.csv", 390.0, 830.0),
}
_BASIS_FILES = {
    1931: ("cie1931-basis-bt709-380+5+780.csv", 380.0, 780.0),
    2006: ("cie2006-basis-bt709-390+1+780.csv", 390.0, 780.0),
}


def planck(lambda_nm: float, temp_k: float) -> float:
    """Planck's law, spectral radiance in W*sr^-1*m^-2*nm^-1 (reference
    src/util/color.cpp:50-66)."""
    lam_m = lambda_nm * 1.0e-9
    c_1l = 2.0 * H * C * C
    c_2 = H * C / K_B
    value = c_1l / (lam_m**5 * (np.exp(c_2 / (lam_m * temp_k)) - 1.0))
    return value * 1.0e-9


def calc_matr_rgb_to_xyz(xy: np.ndarray, xyz_w: np.ndarray) -> np.ndarray:
    """RGB->XYZ matrix from the primaries' chromaticities and the white
    point, a la Lindbloom (reference src/util/color.cpp:26-46)."""
    x, y = xy[:, 0], xy[:, 1]
    rows = np.stack([x / y, np.ones(3), (1.0 - x - y) / y])
    s = np.linalg.solve(rows, xyz_w)
    return rows * s[None, :]


@dataclasses.dataclass
class ColorTables:
    """Device constants for one (observer, mode) configuration (reference
    ``Color::_Data``, src/util/color.hpp:22-69)."""

    obs_values: torch.Tensor  # f32[3, K] CIE x/y/z-bar
    obs_low: float
    obs_inv_step: float
    d65_values: torch.Tensor  # f32[Kd] D65 rescaled to radiance (color.cpp:97-120)
    d65_low: float
    d65_inv_step: float
    d65_rad_xyz: torch.Tensor  # f32[3]
    matr_lrgb_to_xyz: torch.Tensor  # f32[3, 3]
    matr_xyz_to_lrgb: torch.Tensor  # f32[3, 3]
    basis_values: Optional[torch.Tensor] = None  # f32[3, Kb], mallett only
    basis_low: float = 0.0
    basis_inv_step: float = 0.0
    # the jakob pipeline's tables (upsample_jakob.py):
    # tensors beside plain Python ints and floats
    jakob: Optional[dict] = None
    # host-side spectra kept for scene building (never moved to a device)
    host: Optional[dict] = dataclasses.field(default=None, compare=False)

    def to(self, device) -> "ColorTables":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                moved[f.name] = v.to(device)
            elif f.name == "jakob" and v is not None:
                moved[f.name] = {k: t.to(device) if isinstance(t, torch.Tensor) else t for k, t in v.items()}
        return dataclasses.replace(self, **moved)


def build_color_tables(cfg: RenderConfig, device="cuda", dtype=torch.float32) -> ColorTables:
    """Host-side table build, mirroring ``Color::init`` (reference
    src/util/color.cpp:72-155); the tables land on ``device``."""
    device = torch.device(device)
    obs_file, obs_lo, obs_hi = _OBS_FILES[cfg.observer]
    cols = load_spectral_csv(obs_file)
    if len(cols) != 3:
        raise ValueError(f"{obs_file}: expected 3 columns, got {len(cols)}")
    obs = [Spectrum(c, obs_lo, obs_hi) for c in cols]

    # D65: rescale from "100 at 560nm" to physical spectral radiance via
    # Planck's law at the c2-corrected 6500K (reference src/util/color.cpp:97-120).
    d65_orig = Spectrum(load_spectral_csv("d65-300+5+780.csv")[0], 300.0, 780.0)
    if d65_orig.sample_linear(560.0) != 100.0:  # color.cpp:115 invariant
        raise ValueError("D65 table is not normalized to 100 at 560 nm")
    temp_d65 = 6500.0 * (H * C / K_B) / 1.438e-2
    d65_rad = d65_orig * (0.00001 * planck(560.0, temp_d65))
    d65_rad_xyz = np.array([Spectrum.integrate_product(d65_rad, o) for o in obs], dtype=np.float64)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    basis_values = None
    basis_low = basis_inv_step = 0.0
    basis_host = None
    jakob = None
    if cfg.mode == MODE_JAKOB:
        from benchmark.reference.upsample_jakob import load_jakob_tables

        jakob = load_jakob_tables(device, dtype)
    if cfg.mode == MODE_MALLETT:
        basis_file, b_lo, b_hi = _BASIS_FILES[cfg.observer]
        bcols = load_spectral_csv(basis_file)
        basis_host = [Spectrum(c, b_lo, b_hi) for c in bcols]
        basis_values = dev(np.stack(bcols))
        basis_low = float(b_lo)
        basis_inv_step = float(1.0 / basis_host[0].step)

    m_rgb2xyz = calc_matr_rgb_to_xyz(BT709_XY, d65_rad_xyz)
    m_xyz2rgb = np.linalg.inv(m_rgb2xyz)
    return ColorTables(
        obs_values=dev(np.stack([o.values for o in obs])),
        obs_low=float(obs_lo),
        obs_inv_step=float(1.0 / obs[0].step),
        d65_values=dev(d65_rad.values),
        d65_low=float(d65_rad.low),
        d65_inv_step=float(1.0 / d65_rad.step),
        d65_rad_xyz=dev(d65_rad_xyz),
        matr_lrgb_to_xyz=dev(m_rgb2xyz),
        matr_xyz_to_lrgb=dev(m_xyz2rgb),
        basis_values=basis_values,
        basis_low=basis_low,
        basis_inv_step=basis_inv_step,
        jakob=jakob,
        host={
            "obs": obs,
            "d65_orig": d65_orig,
            "d65_rad": d65_rad,
            "d65_rad_xyz": d65_rad_xyz,
            "basis": basis_host,
            "matr_lrgb_to_xyz": m_rgb2xyz,
            "matr_xyz_to_lrgb": m_xyz2rgb,
        },
    )


# --- gamma (exact sRGB piecewise; reference src/util/color.hpp:84-97) ---


def srgb_to_lrgb(srgb: torch.Tensor) -> torch.Tensor:
    lo = srgb / 12.92
    hi = torch.pow(torch.clamp_min((srgb + 0.055) / 1.055, 1e-30), 2.4)
    return torch.where(srgb < 0.04045, lo, hi)


def srgb_to_lrgb_np(srgb: np.ndarray) -> np.ndarray:
    srgb = np.asarray(srgb)
    return np.where(
        srgb < 0.04045,
        srgb / 12.92,
        np.power(np.maximum((srgb + 0.055) / 1.055, 1e-30), 2.4),
    )


# --- XYZ conversions ---


def specradflux_to_ciexyz_hero_soa(
    tables: ColorTables,
    flux: torch.Tensor,
    lambda_0: torch.Tensor,
    n_wavelengths: int,
    lambda_step: float,
    lambda_min: float | None = None,
) -> torch.Tensor:
    """Lanes-last hero-sample XYZ estimator: flux f32[S, N], lambda_0 f32[N]
    -> f32[3, N]; XYZ_c = sum_i obs_c(lambda_i) * flux_i * LAMBDA_STEP
    (reference src/util/color.hpp:115-139).

    Shifted-window form: when LAMBDA_STEP is an integer multiple R of the
    observer pitch, hat(x0 + sR - k) == hat(x0 - (k - sR)), so the S
    per-wavelength hat rows are shifted copies of one [R+2, N] window held
    against S static row slices of the observer table.  ``lambda_min``
    enables it; without it the general [K, S, N] form runs.
    """
    k_dim = tables.obs_values.shape[-1]
    if lambda_min is not None and n_wavelengths >= 1:
        r_ratio = lambda_step * tables.obs_inv_step
        r_int = int(round(r_ratio))
        j0 = (lambda_min - tables.obs_low) * tables.obs_inv_step
        j0_int = int(round(j0))
        if abs(r_ratio - r_int) < 1e-9 and abs(j0 - j0_int) < 1e-9 and j0_int >= 0 and r_int >= 1:
            w_width = r_int + 2  # hat support for x0' in [0, R] incl. edge
            x0 = (lambda_0 - tables.obs_low) * tables.obs_inv_step - j0_int
            iota_j = torch.arange(w_width, dtype=torch.float32, device=flux.device)[:, None]
            w0 = torch.clamp_min(1.0 - torch.abs(x0[None, :] - iota_j), 0.0)  # [W, N]
            obs = tables.obs_values  # [3, K]
            need = j0_int + (n_wavelengths - 1) * r_int + w_width
            if need > k_dim:  # zero rows past the table edge = zero outside range
                obs = torch.cat([obs, obs.new_zeros((3, need - k_dim))], dim=1)
            ow = torch.stack(
                [obs[:, j0_int + s * r_int: j0_int + s * r_int + w_width] for s in range(n_wavelengths)],
                dim=1,
            )  # [3, S, W]
            t = torch.einsum("csj,jn->csn", ow, w0)  # [3, S, N]
            return torch.einsum("csn,sn->cn", t, flux) * lambda_step

    lams = hero_lams_soa(lambda_0, n_wavelengths, lambda_step)  # [S, N]
    x = (lams - tables.obs_low) * tables.obs_inv_step
    w = hat_weights(x, k_dim)  # [K, S, N]
    acc = torch.sum(w * flux[None, :, :], dim=1)  # [K, N]
    return torch.einsum("ck,kn->cn", tables.obs_values, acc) * lambda_step


# --- full-spectrum XYZ (host, at build time; reference src/util/color.hpp:106-111) ---
