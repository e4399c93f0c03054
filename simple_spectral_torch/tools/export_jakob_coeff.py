"""Write a Jakob-Hanika coefficient cube in the reference's ``.coeff``
binary format (PyTorch port of ``tools/export_jakob_coeff.py``; reference
src/jakob-and-hanika-2019/rgb2spec.c:11-47: the magic "SPEC", uint32 res,
f32 scale[res], f32 data[3 * res^3 * 3]).

    python -m simple_spectral_torch.tools.export_jakob_coeff SRC.npz DST.coeff

``SRC`` is a shipped table (``simple_spectral_tpu/data/jakob2019-srgb-{16,64}.npz``)
or one written by ``fit_jakob_coeffs``; ``DST`` is required and may not lie
in the shipped data folder.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def export(src: str, dst: str) -> str:
    """Write the table of the npz ``src`` to ``dst``; returns ``dst``.
    Raises ValueError for a ``dst`` in the shipped data folder or a table
    of the wrong shapes."""
    from simple_spectral_torch.spectra.spectrum import in_data_dir

    if in_data_dir(dst):
        raise ValueError(f"{dst} lies in the shipped data folder, which the port never writes")
    with np.load(src) as z:
        scale = np.asarray(z["scale"], np.float32)
        coeffs = np.asarray(z["coeffs"], np.float32)  # [3, res, res, res, 3]
    res = scale.shape[0]
    if scale.shape != (res,) or coeffs.shape != (3, res, res, res, 3):
        raise ValueError(f"{src}: scale {scale.shape} and coeffs {coeffs.shape} are no cube")
    with open(dst, "wb") as f:
        f.write(b"SPEC")
        f.write(struct.pack("<I", res))
        f.write(scale.tobytes())
        f.write(coeffs.tobytes())
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="export_jakob_coeff", description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="the table's npz")
    p.add_argument("dst", help="the .coeff file to write (not in the shipped data folder)")
    args = p.parse_args(argv)
    try:
        print(export(args.src, args.dst))
    except ValueError as e:
        print(f"export_jakob_coeff: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
