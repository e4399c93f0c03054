"""PNG reading on ``zlib`` and numpy: 8-bit RGB/RGBA non-interlaced
images, the scene textures (frozen from the renderer's own reader, so that
the reference needs no imaging library)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter_row(ftype: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec section 9.2)."""
    n = len(row)
    if ftype == 0:
        return
    if ftype == 1:  # Sub
        for x in range(bpp, n):
            row[x] = (row[x] + row[x - bpp]) & 0xFF
    elif ftype == 2:  # Up
        for x in range(n):
            row[x] = (row[x] + prior[x]) & 0xFF
    elif ftype == 3:  # Average
        for x in range(bpp):
            row[x] = (row[x] + (prior[x] >> 1)) & 0xFF
        for x in range(bpp, n):
            row[x] = (row[x] + ((row[x - bpp] + prior[x]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        for x in range(bpp):
            row[x] = (row[x] + prior[x]) & 0xFF
        for x in range(bpp, n):
            a, b, c = row[x - bpp], prior[x], prior[x - bpp]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            row[x] = (row[x] + pred) & 0xFF
    else:
        raise ValueError(f"bad PNG filter type {ftype}")


def load_png_rgb(path: str) -> np.ndarray:
    """Load an 8-bit RGB or RGBA non-interlaced PNG as u8[H, W, 3],
    scanlines top to bottom (the layout lodepng::decode returns; reference
    src/material.cpp:10-29).  Alpha is dropped."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs are supported "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, expected {h * (stride + 1)}")
    out = bytearray(h * stride)
    prior = bytes(stride)
    for y in range(h):
        base = y * (stride + 1)
        row = bytearray(raw[base + 1:base + 1 + stride])
        _unfilter_row(raw[base], row, prior, bpp)
        out[y * stride:(y + 1) * stride] = row
        prior = bytes(row)
    img = np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)
    return np.ascontiguousarray(img[..., :3])
