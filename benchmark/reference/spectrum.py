"""Spectra: host-side construction + device-side sampling (frozen from the renderer's
``spectra.spectrum``).

* :class:`Spectrum` -- a host-side float64 numpy value type used at init time
  only: scene/table loading, spectrum arithmetic and the exact product
  integrals of the reference's ``Color::init``.
* :class:`SpectrumTable` + :func:`sample_linear` -- the device side: a uniform
  grid of values plus (low, inv_step), sampled with a linear-interp gather.

Semantics match reference src/spectrum.cpp:29-67: linear reconstruction
between uniform samples, identically zero outside ``[low, high]``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np
import torch

# The data files ship once, inside the JAX package's folder; the port reads
# them by path (it imports nothing of that package).
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "simple_spectral_tpu",
    "data",
)


def data_path(*parts: str) -> str:
    return os.path.join(DATA_DIR, *parts)


def load_spectral_csv(path: str) -> List[np.ndarray]:
    """Load a CSV of spectral data as a list of float64 column vectors
    (reference src/spectrum.cpp:177-213)."""
    if not os.path.isabs(path):
        path = data_path(path)
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append([float(tok) for tok in line.replace(",", " ").split()])
    arr = np.asarray(rows, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    return [arr[:, i].copy() for i in range(arr.shape[1])]


class Spectrum:
    """Host-side uniform-grid spectrum over ``[low, high]`` nm, float64
    (reference src/spectrum.hpp:12-64); used only at initialization time."""

    __slots__ = ("values", "low", "high", "step")

    def __init__(self, values: Union[float, Sequence[float], np.ndarray], low: float, high: float):
        if np.isscalar(values):
            values = np.array([float(values)] * 2, dtype=np.float64)
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.size < 2:
            raise ValueError("spectrum needs at least two samples")
        self.low = float(low)
        self.high = float(high)
        self.step = (self.high - self.low) / float(self.values.size - 1)

    @staticmethod
    def constant(value: float, low: float, high: float) -> "Spectrum":
        return Spectrum(np.array([value, value]), low, high)

    # --- sampling (reference src/spectrum.cpp:29-60) ---

    def sample_nearest(self, lam) -> np.ndarray:
        lam = np.asarray(lam, dtype=np.float64)
        i = np.rint((lam - self.low) / self.step).astype(np.int64)
        ok = (i >= 0) & (i < self.values.size)
        return np.where(ok, self.values[np.clip(i, 0, self.values.size - 1)], 0.0)

    def sample_linear(self, lam) -> np.ndarray:
        lam = np.asarray(lam, dtype=np.float64)
        x = (lam - self.low) / self.step
        i0 = np.floor(x)
        frac = x - i0
        i0 = i0.astype(np.int64)
        i1 = i0 + 1
        n = self.values.size
        v0 = np.where((i0 >= 0) & (i0 < n), self.values[np.clip(i0, 0, n - 1)], 0.0)
        v1 = np.where((i1 >= 0) & (i1 < n), self.values[np.clip(i1, 0, n - 1)], 0.0)
        return v0 * (1.0 - frac) + v1 * frac

    # --- arithmetic (init-time only; reference src/spectrum.cpp:69-117) ---

    def __mul__(self, other):
        if np.isscalar(other):
            return Spectrum(self.values * float(other), self.low, self.high)
        # nearest resample of both onto the overlapping grid (spectrum.cpp:74-95)
        low = max(self.low, other.low)
        high = min(self.high, other.high)
        n = int(round((high - low) / self.step)) + 1
        lams = low + self.step * np.arange(n)
        return Spectrum(self.sample_nearest(lams) * other.sample_nearest(lams), low, high)

    __rmul__ = __mul__

    def __add__(self, other: "Spectrum") -> "Spectrum":
        low = max(self.low, other.low)
        high = min(self.high, other.high)
        n = int(round((high - low) / self.step)) + 1
        lams = low + self.step * np.arange(n)
        return Spectrum(self.sample_nearest(lams) + other.sample_nearest(lams), low, high)

    # --- integrals (reference src/spectrum.cpp:119-173) ---

    def integrate(self) -> float:
        """Midpoint-rule integral (reference src/spectrum.cpp:119-133)."""
        return float(self.values.sum() * self.step)

    @staticmethod
    def integrate_product(a: "Spectrum", b: "Spectrum") -> float:
        """Trapezoid rule on the merged sample points of both spectra,
        including the one-sample-outward extension (spectrum.cpp:134-173)."""
        low = max(a.low - a.step, b.low - b.step)
        high = min(a.high + a.step, b.high + b.step)
        pts = set()
        for s in (a, b):
            lam = s.low - s.step
            if lam < low:
                k = int(np.ceil((low - lam) / s.step - 1e-9))
                lam = lam + k * s.step
            while lam <= high + 1e-9:
                pts.add(round(lam, 6))
                lam += s.step
        pts = np.asarray(sorted(pts), dtype=np.float64)
        if pts.size < 2:
            return 0.0
        prod = a.sample_linear(pts) * b.sample_linear(pts)
        return float(np.sum(0.5 * (prod[:-1] + prod[1:]) * np.diff(pts)))

    def to_table(self, dtype=torch.float32, device="cpu") -> "SpectrumTable":
        return SpectrumTable(
            values=torch.as_tensor(self.values, dtype=dtype, device=device),
            low=float(self.low),
            inv_step=float(1.0 / self.step),
        )


class SpectrumTable:
    """Device representation of a uniform-grid spectrum: (values[K], low,
    inv_step), sampled by :func:`sample_linear`."""

    __slots__ = ("values", "low", "inv_step")

    def __init__(self, values: torch.Tensor, low: float, inv_step: float):
        self.values = values
        self.low = low
        self.inv_step = inv_step

    def to(self, device) -> "SpectrumTable":
        return SpectrumTable(self.values.to(device), self.low, self.inv_step)


# --- device-side sampling primitives ---


def sample_linear(values: torch.Tensor, low: float, inv_step: float, lam: torch.Tensor):
    """Linear-reconstruction sample of a 1-D uniform-grid table ``values``
    f32[K] at wavelengths ``lam`` (any shape); zero outside the table
    (reference src/spectrum.cpp:39-60)."""
    x = (lam - low) * inv_step
    i0f = torch.floor(x)
    frac = x - i0f
    i0 = i0f.to(torch.int64)
    n = values.shape[-1]
    v0 = torch.where((i0 >= 0) & (i0 < n), values[i0.clamp(0, n - 1)], 0.0)
    i1 = i0 + 1
    v1 = torch.where((i1 >= 0) & (i1 < n), values[i1.clamp(0, n - 1)], 0.0)
    return v0 * (1.0 - frac) + v1 * frac


def sample_nearest(values: torch.Tensor, low: float, inv_step: float, lam: torch.Tensor):
    """Nearest-reconstruction sample; zero outside the table (reference
    src/spectrum.cpp:29-38).  ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    i = torch.round((lam - low) * inv_step).to(torch.int64)
    n = values.shape[-1]
    ok = (i >= 0) & (i < n)
    return torch.where(ok, values[i.clamp(0, n - 1)], 0.0)


def hero_lams_soa(lam0: torch.Tensor, n_wavelengths: int, lambda_step: float):
    """f32[N] -> f32[S, N] hero wavelengths, lanes last (reference
    src/spectrum.cpp:61-67)."""
    offs = torch.arange(n_wavelengths, dtype=torch.float32, device=lam0.device) * lambda_step
    return lam0[None, :] + offs[:, None]


def hat_weights(x: torch.Tensor, k_dim: int):
    """x: f32[..., N] fractional table coordinate -> f32[K, ..., N] linear
    reconstruction ('hat' basis) weights: sum_k table[k] * hat(x - k) is
    linear interpolation with zero outside the table."""
    iota = torch.arange(k_dim, dtype=torch.float32, device=x.device).reshape(
        (k_dim,) + (1,) * x.dim()
    )
    return torch.clamp_min(1.0 - torch.abs(x[None] - iota), 0.0)
