"""Jakob & Hanika 2019 sigmoid-polynomial spectral upsampling ("jakob" mode;
frozen from the renderer's ``spectra.upsample_jakob``).

A max-component-parameterized coefficient cube fetch (trilinear
interpolation over a non-uniform brightness axis, reference
rgb2spec.c:77-118) followed by the sigmoid-polynomial evaluation
S(lam) = 1/2 x / sqrt(x^2+1) + 1/2 with x = c0 lam^2 + c1 lam + c2
(rgb2spec_eval_precise, rgb2spec.c:129-133).  The coefficient cube is the
JAX package's own fit, read in place from its data folder; a cube the port
fits itself (``tools/fit_jakob_coeffs.py``) goes through
:func:`jakob_tables_from_arrays`.

As in the JAX package, inputs are clamped to [0,1] and pure black (z = 0,
undefined in the C) gives the coefficients (0, 0, -1e6): reflectance 0.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.spectrum import data_path

DEFAULT_RES = 64


def jakob_tables_from_arrays(scale, coeffs, device="cpu", dtype=torch.float32) -> dict:
    """A coefficient cube as the fetch reads it: ``scale`` f32[res]
    (monotonic z nodes), ``coeffs`` f32[3 * res^3, 3] (flattened [comp, z, y,
    x] rows) and ``res``, from ``scale`` [res] and ``coeffs`` [3, res, res,
    res, 3] arrays."""
    coeffs = np.asarray(coeffs)
    return {
        "scale": torch.as_tensor(scale, dtype=dtype, device=device),
        "coeffs": torch.as_tensor(coeffs.reshape(-1, 3), dtype=dtype, device=device),
        "res": int(coeffs.shape[1]),
    }


def load_jakob_tables(device="cpu", dtype=torch.float32, res: int = DEFAULT_RES) -> dict:
    """The shipped coefficient cube (:func:`jakob_tables_from_arrays`)."""
    with np.load(data_path(f"jakob2019-srgb-{res}.npz")) as z:
        return jakob_tables_from_arrays(z["scale"], z["coeffs"], device, dtype)


def rgb2spec_fetch_soa(jak: dict, r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Per-lane coefficient fetch (reference rgb2spec.c:77-118).
    r/g/b: f32[N] -> (c0, c1, c2) f32[N] each, nm units."""
    res = jak["res"]
    scale_nodes = jak["scale"]
    r = torch.clamp(r, 0.0, 1.0)
    g = torch.clamp(g, 0.0, 1.0)
    b = torch.clamp(b, 0.0, 1.0)

    # the largest component, with the C loop's >= / last-wins ties
    i = torch.where(g >= r, 1, 0)
    zi_max = torch.where(i == 1, g, r)
    i = torch.where(b >= zi_max, 2, i)

    z = torch.maximum(torch.maximum(r, g), b)
    ok = z > 0.0
    inv_z = torch.where(ok, (res - 1) / torch.where(ok, z, 1.0), 0.0)

    def comp(k):  # rgb[(i+k)%3]
        sel = (i + k) % 3
        return torch.where(sel == 0, r, torch.where(sel == 1, g, b))

    x = comp(1) * inv_z
    y = comp(2) * inv_z

    xi = torch.clamp_max(x.to(torch.int64), res - 2)
    yi = torch.clamp_max(y.to(torch.int64), res - 2)
    # find_interval on the non-uniform scale nodes (rgb2spec.c:55-72)
    zi = torch.clamp(torch.searchsorted(scale_nodes, z, right=False) - 1, 0, res - 2)

    x1 = x - xi.to(torch.float32)
    x0 = 1.0 - x1
    y1 = y - yi.to(torch.float32)
    y0 = 1.0 - y1
    s_lo = scale_nodes[zi]
    s_hi = scale_nodes[zi + 1]
    z1 = (z - s_lo) / (s_hi - s_lo)
    z0 = 1.0 - z1

    base = ((i.to(torch.int64) * res + zi) * res + yi) * res + xi  # row of [3 res^3, 3]
    dz = res * res
    dy = res
    table = jak["coeffs"]

    def corner(off):
        return table[base + off]  # f32[N, 3]

    w_x0, w_x1 = x0[:, None], x1[:, None]
    w_y0, w_y1 = y0[:, None], y1[:, None]
    w_z0, w_z1 = z0[:, None], z1[:, None]
    out = (
        ((corner(0) * w_x0 + corner(1) * w_x1) * w_y0 + (corner(dy) * w_x0 + corner(dy + 1) * w_x1) * w_y1) * w_z0
        + ((corner(dz) * w_x0 + corner(dz + 1) * w_x1) * w_y0
           + (corner(dz + dy) * w_x0 + corner(dz + dy + 1) * w_x1) * w_y1) * w_z1
    )
    c0 = torch.where(ok, out[:, 0], 0.0)
    c1 = torch.where(ok, out[:, 1], 0.0)
    c2 = torch.where(ok, out[:, 2], -1e6)
    return c0, c1, c2


# q32 texel format (config.texel_format="u32"): the three coefficients,
# rebased to t = (lam - LC) / LH, asinh-companded and quantized to 10/11/11
# bits in ONE 32-bit word per texel (the JAX package's upsample_jakob.py
# explains the encoding and measures its fidelity).  The a2 code 0x7FF is
# reserved for black.  The word's bit 31 is q0's top bit: the port holds the
# words as int32, so a word with q0 >= 512 is negative, and every field is
# masked after its (arithmetic) shift.
JAKOB_Q32_LC = 605.0
JAKOB_Q32_LH = 225.0
_Q32_BITS = (10, 11, 11)
_Q32_SIGMA = (4.0, 4.0, 1.0)
_Q32_BLACK = (1 << 11) - 1  # reserved a2 code


def jakob_q32_pack(c0, c1, c2):
    """Host-side pack: nm-unit coefficient arrays (numpy, [T]) ->
    (words u32[T], meta f32[9] = (lo, step, sigma) per coefficient)."""
    c0 = np.asarray(c0, np.float64)
    c1 = np.asarray(c1, np.float64)
    c2 = np.asarray(c2, np.float64)
    black = c2 < -1e5
    lc, lh = JAKOB_Q32_LC, JAKOB_Q32_LH
    a_all = (
        c0 * lh * lh,
        (2.0 * c0 * lc + c1) * lh,
        c0 * lc * lc + c1 * lc + c2,
    )
    qs, meta = [], []
    for k, (a, bits, sig) in enumerate(zip(a_all, _Q32_BITS, _Q32_SIGMA)):
        reserve = 1 if k == 2 else 0
        u = np.arcsinh(np.where(black, 0.0, a) / sig)
        sel = u[~black]
        lo = float(sel.min()) if sel.size else 0.0
        hi = float(sel.max()) if sel.size else 1.0
        n = (1 << bits) - 1 - reserve
        du = (hi - lo) / n if hi > lo else 1.0
        q = np.clip(np.round((u - lo) / du), 0, n).astype(np.uint32)
        qs.append(q)
        meta += [lo, du, sig]
    q0, q1, q2 = qs
    q2 = np.where(black, np.uint32(_Q32_BLACK), q2)
    words = (q0 << np.uint32(22)) | (q1 << np.uint32(11)) | q2
    return words.astype(np.uint32), np.asarray(meta, np.float32)


def jakob_q32_eval_soa(words: torch.Tensor, meta: torch.Tensor, lam0: torch.Tensor, n_wavelengths: int,
                       lambda_step: float) -> torch.Tensor:
    """Decode + sigmoid evaluation: words i32[N] (the u32 bits), meta
    f32[9], lam0 f32[N] -> reflectance f32[S, N]."""
    words = words.to(torch.int32)
    q0 = (words >> 22) & 0x3FF
    q1 = (words >> 11) & 0x7FF
    q2 = words & 0x7FF
    black = q2 == _Q32_BLACK

    def deq(q, o):
        u = meta[o] + q.to(torch.float32) * meta[o + 1]
        return meta[o + 2] * torch.sinh(u)

    a0, a1, a2 = deq(q0, 0), deq(q1, 3), deq(q2, 6)
    inv_lh = 1.0 / JAKOB_Q32_LH
    outs = []
    for s in range(n_wavelengths):
        t = (lam0 + (s * lambda_step) - JAKOB_Q32_LC) * inv_lh
        x = (a0 * t + a1) * t + a2
        refl = 0.5 * x * torch.rsqrt(x * x + 1.0) + 0.5
        outs.append(torch.where(black, 0.0, refl))
    return torch.stack(outs)


def rgb2spec_eval_soa(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, lams: torch.Tensor) -> torch.Tensor:
    """Sigmoid-polynomial evaluation (rgb2spec_eval_precise,
    rgb2spec.c:129-133).  c*: f32[N]; lams: f32[S, N] -> f32[S, N]."""
    x = (c0[None, :] * lams + c1[None, :]) * lams + c2[None, :]
    y = torch.rsqrt(x * x + 1.0)
    return 0.5 * x * y + 0.5
