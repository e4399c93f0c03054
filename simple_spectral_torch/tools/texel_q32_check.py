"""Fidelity of jakob's q32 texel words (``texel_format="u32"``) on the
shipped texture, against the exact coefficients (PyTorch port of
``tools/texel_q32_check.py``).

    python -m simple_spectral_torch.tools.texel_q32_check [out.json] [--crop S] [--device cpu]

As the JAX tool (``tools/texel_q32_check.py:37-111``): plane-srgb, jakob;
the texture read by the port's PNG codec (``io/image.py`` ``load_png_rgb``;
the JAX tool uses PIL), ``srgb_to_lrgb_np``, the cube fetch
``rgb2spec_fetch_soa`` (f32, on the device, as the scene build runs it),
its coefficients widened to f64, and ``jakob_q32_pack``.  The exact
reflectance is the sigmoid of the f64 coefficients on the observer's
wavelength grid; the quantized one is the port's own decode,
``jakob_q32_eval_soa`` at S = 1, once per observer wavelength, on the device
(the decode the render runs).  Three figures, under the JAX tool's keys:

1. ``pointwise_refl_err``: |error| over (texel, wavelength): max, mean, and
   the 0.999 quantile;
2. ``per_texel_xyz_err``: |error| of each texel's XYZ under the observer
   (flat illuminant, normalized by the Y sum);
3. ``block16_mean_Y_err``: the Y error's means over 16x16-texel blocks,
   their largest magnitude and their rms;

with ``texture``, ``texels``, ``format`` and the note on the parity tests'
block tolerance, and ``device``, where the decode ran.  It prints the dict
and writes it when given a path.  It runs on the card unless ``--device
cpu`` is given, and exits 1 without one; ``--crop S`` (a multiple of 16)
takes the top-left S x S texels, and packs those alone, for the CPU check.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import tool_device, write_json

BLOCK = 16
NOTE = ("tests/artifacts/parity_stats.json block means ~4e-3; the block-mean Y error here must sit well inside "
        "that")


def config() -> RenderConfig:
    return RenderConfig(scene="plane-srgb", mode="jakob")


def load_texture(cfg: RenderConfig, crop: int = None) -> np.ndarray:
    """The scene's texture, u8[S, S, 3], cut to its top-left ``crop`` x
    ``crop`` texels when given."""
    from simple_spectral_torch.io.image import load_png_rgb
    from simple_spectral_torch.spectra.spectrum import data_path

    img = load_png_rgb(data_path("scenes", cfg.texture))
    return img[:crop, :crop] if crop else img


def pack(img: np.ndarray, jakob: dict, dev):
    """The cube fetch of the texels on ``dev`` and the host pack: (c0, c1,
    c2 f64[T], words u32[T], meta f32[9])."""
    from simple_spectral_torch.spectra.colorimetry import srgb_to_lrgb_np
    from simple_spectral_torch.spectra.upsample_jakob import jakob_q32_pack, rgb2spec_fetch_soa

    lrgb = srgb_to_lrgb_np(img.reshape(-1, 3).astype(np.float32) / 255.0)
    rgb = (torch.as_tensor(np.ascontiguousarray(lrgb[:, c]), dtype=torch.float32, device=dev) for c in range(3))
    c0, c1, c2 = (c.cpu().numpy().astype(np.float64) for c in rgb2spec_fetch_soa(jakob, *rgb))
    words, meta = jakob_q32_pack(c0, c1, c2)
    return c0, c1, c2, words, meta


def decode(words: np.ndarray, meta: np.ndarray, lam: np.ndarray, dev) -> np.ndarray:
    """The quantized reflectance f64[T, K]: ``jakob_q32_eval_soa`` at S = 1
    on ``dev``, once per wavelength of ``lam``."""
    from simple_spectral_torch.spectra.upsample_jakob import jakob_q32_eval_soa

    w = torch.from_numpy(words.view(np.int32)).to(dev)
    m = torch.from_numpy(meta).to(dev)
    cols = [jakob_q32_eval_soa(w, m, torch.full(w.shape, float(np.float32(x)), device=dev), 1, 0.0)[0]
            for x in lam]
    return torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)


def figures(cfg: RenderConfig, tables, img: np.ndarray, dev) -> dict:
    """The JAX tool's result dict for the texels of ``img``."""
    side = img.shape[0]
    c0, c1, c2, words, meta = pack(img, tables.jakob, dev)
    obs = tables.obs_values.cpu().numpy().astype(np.float64)  # [3, K]
    lam = tables.obs_low + np.arange(obs.shape[1]) / tables.obs_inv_step
    xx = (c0[:, None] * lam[None, :] + c1[:, None]) * lam[None, :] + c2[:, None]
    r_f = 0.5 * xx / np.sqrt(xx * xx + 1.0) + 0.5
    r_q = decode(words, meta, lam, dev)

    e = np.abs(r_q - r_f)
    ysum = obs[1].sum()
    xyz_f = (r_f @ obs.T) / ysum
    xyz_q = (r_q @ obs.T) / ysum
    d = np.abs(xyz_q - xyz_f)
    ey = (xyz_q - xyz_f)[:, 1].reshape(side, side)
    nb = side // BLOCK
    bm = ey.reshape(nb, BLOCK, nb, BLOCK).mean(axis=(1, 3))
    return {
        "texture": cfg.texture,
        "texels": int(len(words)),
        "format": "q32 asinh-companded 10/11/11 (lo/step/sigma meta)",
        "pointwise_refl_err": {"max": float(e.max()), "mean": float(e.mean()), "p999": float(np.quantile(e, 0.999))},
        "per_texel_xyz_err": {"max": float(d.max()), "mean": float(d.mean()), "p999": float(np.quantile(d, 0.999))},
        "block16_mean_Y_err": {"max_abs": float(np.abs(bm).max()), "rms": float(np.sqrt((bm ** 2).mean()))},
        "parity_block_tolerance_note": NOTE,
    }


def one_code(meta: np.ndarray, lam: np.ndarray) -> float:
    """The most one code of one q32 field can move a reflectance over the
    wavelengths ``lam``: a step of field k moves a_k by sigma_k times
    sinh's step at the end of the field's range, x = (a0 t + a1) t + a2 by
    that times |t|^(2 - k), and the sigmoid 0.5 x / sqrt(x^2 + 1) + 0.5 by
    at most half of x's move."""
    from simple_spectral_torch.spectra.upsample_jakob import JAKOB_Q32_LC, JAKOB_Q32_LH

    t = np.abs((lam - JAKOB_Q32_LC) / JAKOB_Q32_LH).max()
    worst = 0.0
    for k, bits in enumerate((10, 11, 11)):
        lo, du, sig = (float(v) for v in meta[3 * k:3 * k + 3])
        hi = lo + ((1 << bits) - 1 - (k == 2)) * du  # field 2 reserves its top code
        step = sig * max(abs(np.sinh(hi) - np.sinh(hi - du)), abs(np.sinh(lo + du) - np.sinh(lo)))
        worst = max(worst, float(0.5 * step * t ** (2 - k)))
    return worst


def bounds(tables, meta: np.ndarray, moved: int, texels: int, decode: float) -> dict:
    """How far two runs' figures may lie apart, by figure, when ``moved``
    of their ``texels`` q32 words differ by a code of one field and their
    decodes agree within ``decode``: ``decode`` plus, where words moved,
    one code's move (:func:`one_code`), whole for a max or a quantile, over
    the texels (a block's 256 for the block means) for a mean; XYZ figures
    scale by the largest observer sum over the Y sum."""
    obs = tables.obs_values.cpu().numpy().astype(np.float64)
    code = one_code(meta, tables.obs_low + np.arange(obs.shape[1]) / tables.obs_inv_step)
    whole, mean = decode + code * (moved > 0), decode + code * moved / texels
    xyz = float(obs.sum(axis=1).max() / obs[1].sum())
    return {
        "pointwise_refl_err": {"max": whole, "mean": mean, "p999": whole},
        "per_texel_xyz_err": {"max": whole * xyz, "mean": mean * xyz, "p999": whole * xyz},
        "block16_mean_Y_err": {k: decode + code * moved / (BLOCK * BLOCK) for k in ("max_abs", "rms")},
    }


def main(argv=None) -> int:
    from simple_spectral_torch.bench import device_line
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--crop", type=int, default=None, help="top-left S x S texels only (S a multiple of 16)")
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    args = p.parse_args(argv)
    if args.crop is not None and (args.crop <= 0 or args.crop % BLOCK):
        p.error(f"--crop must be a positive multiple of {BLOCK}, got {args.crop}")
    dev = tool_device(args.device, "texel_q32_check")
    if dev is None:
        return 1

    cfg = config()
    with torch.no_grad():
        result = figures(cfg, build_color_tables(cfg, device=dev), load_texture(cfg, args.crop), dev)
    result["device"] = device_line(dev)
    print(json.dumps(result, indent=1))
    write_json(args.out, result)
    if args.out:
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
