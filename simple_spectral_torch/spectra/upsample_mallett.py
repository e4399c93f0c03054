"""Mallett-Yuksel sRGB spectral-primary decomposition ("Ours").

lrgb -> hero-sampled spectral reflectance as a linear combination of the
three basis spectra (reference src/util/color.cpp:166-173).
"""

from __future__ import annotations

import torch

from simple_spectral_torch.spectra.colorimetry import ColorTables
from simple_spectral_torch.spectra.spectrum import sample_linear


def lrgb_to_specrefl_mallett(
    tables: ColorTables, lrgb: torch.Tensor, lambda_0: torch.Tensor, n_wavelengths: int, lambda_step: float
) -> torch.Tensor:
    """lrgb: f32[..., 3]; lambda_0: f32[...] -> f32[..., S] reflectance sample."""
    offs = torch.arange(n_wavelengths, dtype=lambda_0.dtype, device=lambda_0.device) * lambda_step
    lams = lambda_0[..., None] + offs  # [..., S]
    out = 0.0
    for c in range(3):
        basis_c = sample_linear(tables.basis_values[c], tables.basis_low, tables.basis_inv_step, lams)
        out = out + lrgb[..., c, None] * basis_c
    return out
