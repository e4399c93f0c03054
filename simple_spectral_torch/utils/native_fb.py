"""ctypes binding of the native framebuffer runtime (PyTorch port of
``simple_spectral_tpu.utils.native_fb``).

``native/framebuffer.cpp`` is framework-neutral C++ (an f64 accumulator, a
tonemap to u8 and an asynchronous checkpoint writer behind a plain C ABI),
so the port reads it in place: at first use it is compiled with the host
C++ compiler into ``simple_spectral_torch/_build/`` and loaded with
``ctypes``.  The library is rebuilt when the source is newer.  Both packages
build the same source, so their checkpoints have one format.
``load_native()`` returns None when the library cannot be built (no
compiler, no source, or a failed compile, whose output the
``NativeFramebuffer`` error carries); the progressive renderer then
accumulates in numpy unless ``native=True`` asked for this one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "framebuffer.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libssfb.so")

# framebuffer.cpp uses std::string without including <string>; libstdc++ 13
# no longer brings it in through <thread>, so the header is forced in here
# (the source is shared with the JAX package and read as it is)
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", "-include", "string"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _build() -> str:
    """Path of the built library; raises RuntimeError with the reason when
    it cannot be built."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, c++ or clang++) on PATH")
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"no native source at {SOURCE}")
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build beside the library and rename, so that a process loading it
    # never sees a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


def load_native():
    """The ctypes library, built if needed; None when unavailable (the
    reason is kept for :class:`NativeFramebuffer`'s error)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            path = _build()
        except RuntimeError as e:
            _error = str(e)
            return None
        lib = ctypes.CDLL(path)
        lib.ssfb_create.restype = ctypes.c_void_p
        lib.ssfb_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
        lib.ssfb_destroy.restype = None
        lib.ssfb_destroy.argtypes = [ctypes.c_void_p]
        lib.ssfb_add_chunk.restype = None
        lib.ssfb_add_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.ssfb_note_pass.restype = None
        lib.ssfb_note_pass.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.ssfb_spp_done.restype = ctypes.c_uint64
        lib.ssfb_spp_done.argtypes = [ctypes.c_void_p]
        lib.ssfb_mean.restype = None
        lib.ssfb_mean.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.ssfb_tonemap_srgb_u8.restype = None
        lib.ssfb_tonemap_srgb_u8.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ssfb_checkpoint_async.restype = ctypes.c_int
        lib.ssfb_checkpoint_async.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ssfb_checkpoint_wait.restype = ctypes.c_int
        lib.ssfb_checkpoint_wait.argtypes = [ctypes.c_void_p]
        lib.ssfb_checkpoint_load.restype = ctypes.c_int
        lib.ssfb_checkpoint_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeFramebuffer:
    """The C++ accumulator of a width x height image.  Raises RuntimeError
    when the native library cannot be built."""

    def __init__(self, width: int, height: int):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native framebuffer library unavailable: {_error}")
        self._lib = lib
        self._h = lib.ssfb_create(width, height)
        self.width = width
        self.height = height

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ssfb_destroy(self._h)  # joins a pending checkpoint write
            self._h = None

    def add_chunk(self, offset: int, value3: np.ndarray, alpha: np.ndarray):
        """Add f32[P, 3] value sums and f32[P] alpha sums at pixel ``offset``."""
        value3 = np.ascontiguousarray(value3, np.float32)
        alpha = np.ascontiguousarray(alpha, np.float32)
        n = alpha.shape[0]
        if value3.shape != (n, 3) or not 0 <= offset <= self.width * self.height - n:
            raise ValueError(f"chunk of {value3.shape} values at {offset} does not fit "
                             f"{self.width}x{self.height}")
        self._lib.ssfb_add_chunk(self._h, offset, n, _fptr(value3), _fptr(alpha))

    def note_pass(self, pass_spp: int):
        self._lib.ssfb_note_pass(self._h, pass_spp)

    @property
    def spp_done(self) -> int:
        return int(self._lib.ssfb_spp_done(self._h))

    def mean(self):
        n = self.width * self.height
        value = np.empty((n, 3), np.float64)
        alpha = np.empty((n,), np.float64)
        self._lib.ssfb_mean(self._h, _dptr(value), _dptr(alpha))
        return value.reshape(self.height, self.width, 3), alpha.reshape(self.height, self.width)

    def tonemap_srgb_u8(self, matrix: np.ndarray, flip_rows: bool = True) -> np.ndarray:
        """``matrix`` f32[3, 3] applied to the mean value, then the exact
        sRGB gamma; returns u8[H, W, 4] (top to bottom with ``flip_rows``)."""
        m = np.ascontiguousarray(matrix, np.float32).reshape(-1)
        out = np.empty((self.height, self.width, 4), np.uint8)
        self._lib.ssfb_tonemap_srgb_u8(self._h, _fptr(m), int(flip_rows),
                                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out

    def checkpoint_async(self, path: str) -> bool:
        """Snapshot the state and write it to ``path`` on a background thread."""
        return bool(self._lib.ssfb_checkpoint_async(self._h, path.encode()))

    def checkpoint_wait(self) -> bool:
        """Wait for the pending write; False if it failed."""
        return bool(self._lib.ssfb_checkpoint_wait(self._h))

    def checkpoint_load(self, path: str) -> bool:
        return bool(self._lib.ssfb_checkpoint_load(self._h, path.encode()))
