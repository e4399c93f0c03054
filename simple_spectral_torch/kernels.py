"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C launch
function; sources may include headers beside them (``#include "x.cuh"``).
It is compiled with ``nvcc`` at first use into
``simple_spectral_torch/_build/`` (one shared library per source, named by a
hash of the source, the headers it includes and the flags) and loaded with
``ctypes``.  :func:`build`
starts one ``nvcc`` per source that is not built yet, all at once, and waits
for them together.  Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# -fmad=false: every FP32 operation rounds once, as the plain twins' unfused
# torch operations do, so each kernel agrees with its twin bit for bit.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found: the CUDA kernels are built from source at first use")


def includes(source: str) -> list:
    """Paths of the headers ``source`` includes with quotes, beside it,
    and of those they include in turn, each once, in the order met."""
    found, todo = [], [source]
    while todo:
        path = todo.pop(0)
        with open(path) as f:
            names = re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read(), flags=re.M)
        for name in names:
            header = os.path.join(os.path.dirname(path), name)
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(source: str) -> str:
    """Path of the built library of ``source``, keyed by a hash of the
    source, the headers it includes and the flags."""
    h = hashlib.sha256()
    for path in (source, *includes(source)):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build(*sources: str) -> list:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together; returns the libraries' paths in the order given.
    Raises with the compiler's output if any build fails."""
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = cuda_tool("nvcc")
    jobs = []
    try:
        for src, path in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((src, path, tmp, proc))
        errors = []
        for src, path, tmp, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {os.path.basename(src)} ({proc.returncode}):\n{out}\n{err}")
            else:
                os.replace(tmp, path)
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(source: str, fn_name: str, argtypes: list):
    """The launch function ``fn_name`` of ``source``'s library (built if
    needed), with its argument types set and an int return (a cudaError_t)."""
    key = (source, fn_name)
    if key not in _loaded:
        lib = ctypes.CDLL(build(source)[0])
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[key] = (lib, fn)  # the library stays open while the function is used
    return _loaded[key][1]
