"""Image input and output, host-side (PyTorch port of
``simple_spectral_tpu.io.image``).

``save_image`` picks the format by extension: ``.csv`` (lRGB floats),
``.hdr`` (RADIANCE rgbe), ``.pfm`` (raw f32), default PNG (reference
src/framebuffer.cpp:39-176).  Its input is the framebuffer convention of the
package: sRGB+A float32 ``[H, W, 4]`` with row 0 at the *bottom* (reference
src/framebuffer.hpp:23-26).

PNG reading and writing use a small codec on ``zlib`` and numpy, so the port
needs no imaging library: it reads 8-bit RGB/RGBA non-interlaced PNGs (the
scene textures) and writes RGBA8 with filter 0.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from simple_spectral_torch.spectra.colorimetry import srgb_to_lrgb_np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def save_image(path: str, fb: np.ndarray) -> None:
    fb = np.asarray(fb, np.float32)
    if fb.ndim != 3 or fb.shape[2] not in (3, 4):
        raise ValueError(f"framebuffer must be [H, W, 3|4], got {fb.shape}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".csv":
        _save_csv(path, fb)
    elif ext == ".hdr":
        _save_hdr(path, fb)
    elif ext == ".pfm":
        _save_pfm(path, fb)
    else:
        _save_png(path, fb)


def _save_png(path: str, fb: np.ndarray) -> None:
    """Clamp, quantize, flip to top-to-bottom (reference
    src/framebuffer.cpp:141-175)."""
    rgba = fb if fb.shape[2] == 4 else np.concatenate([fb, np.ones_like(fb[..., :1])], axis=-1)
    u8 = np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)
    write_png_rgba(path, u8[::-1])


def _save_csv(path: str, fb: np.ndarray) -> None:
    """Linear-RGB text rows in framebuffer order, i.e. bottom-to-top
    (reference src/framebuffer.cpp:40-63)."""
    lrgb = srgb_to_lrgb_np(fb[..., :3])
    with open(path, "w") as f:
        for row in lrgb:
            f.write(",".join(f"{v:g}" for px in row for v in px))
            f.write("\n")


def _save_pfm(path: str, fb: np.ndarray) -> None:
    """PFM: raw linear RGB f32, little-endian scale -1, rows written top
    first (reference src/framebuffer.cpp:112-140)."""
    lrgb = np.ascontiguousarray(srgb_to_lrgb_np(fb[..., :3])[::-1], np.float32)
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{fb.shape[1]} {fb.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(lrgb.tobytes())


def _save_hdr(path: str, fb: np.ndarray) -> None:
    """RADIANCE .hdr: linear RGB as shared-exponent rgbe pixels, flat
    scanlines, top to bottom (reference src/framebuffer.cpp:64-111)."""
    lrgb = srgb_to_lrgb_np(fb[..., :3])[::-1]
    h, w = lrgb.shape[:2]
    maxc = lrgb.max(axis=-1)
    _, e = np.frexp(maxc)
    mult = np.where(maxc >= 1e-32, np.ldexp(256.0, -e), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(np.round(lrgb * mult[..., None]), 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc >= 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\nEXPOSURE=1.0\nSOFTWARE=simple-spectral-tpu\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# --- PNG codec (zlib + numpy) ---


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png_rgba(path: str, rgba: np.ndarray) -> None:
    """Write u8[H, W, 4] (scanlines top to bottom) as an RGBA8 PNG, every
    scanline with filter type 0."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError(f"expected RGBA u8[H, W, 4], got {rgba.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


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
