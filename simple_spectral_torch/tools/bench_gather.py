"""The u32 texel gather on the card: kernel gather_u32 against its twin and
``torch.take``.

    python -m simple_spectral_torch.tools.bench_gather [--lanes 262144] [--size 512] [--reps 30]

The port's counterpart of the JAX package's TPU gather spikes
(``tools/bench_pallas_gather.py``, ``tools/bench_gather2.py``,
``tools/bench_gather3.py``, ``tools/bench_rng_gather.py``).  Their five
Pallas functions compute one thing, a gather of 32-bit words, which the CUDA
kernel ``gather_u32`` (``csrc/gather_u32.cu``) computes for an index array
``idx[rows, cols]``:

    axis 0:  out[i, j] = table[(idx[i, j] & mask) * cols + j]
    axis 1:  out[i, j] = table[i * cols + (idx[i, j] & mask)]

``take_along_axis`` on axis 0 and 1 of a [2048, 128] table is each axis; a
flat take (``bench_gather2``'s ``gk``, and ``bench_gather3``'s and
``bench_rng_gather``'s lane takes ``& (T - 1)`` from the 8-row broadcast
table) is axis 0 with ``cols = 1`` and ``mask = T - 1``.

The entry point gathers the real merged texel-fetch indices of one
cornell-srgb sample (mallett, 512x512, depth 10; collected from
``trace_lanes``'s geometry phase by a hook here, not on the render path) and
then times, at the spikes' sizes (T = 262144 words, 9 x 262144 indices:
random, all-zero, coherent; and both axes of the [2048, 128] table), the
kernel, its plain twin and the one PyTorch call that computes the same
gather (``torch.take``, or ``torch.gather`` for the two axes), each beside
its byte bound.  Every output is held against the twin's, word for word.
Kernel and library times are the card's alone (``tools.cuda_time_ms``:
``--reps`` launches back to back behind a device spin, the table warm in
L2 as on a render); the twin's are host-inclusive
(``tools.host_inclusive_ms``).

The kernel stays off the render path: the JAX package's render gathers its
texels with ``jnp.take``, as the port does with indexing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from simple_spectral_torch import kernels
from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools import bound_ms, cuda_time_ms, host_inclusive_ms

T = 262144  # the spikes' table, in words
D = 9  # index rows of the merged fetch (the bounces at depth 10)
N = 262144  # lanes
TABLE_2D = (2048, 128)  # the [T/128, 128] table of take_along_axis

# Launches of the CUDA kernel, counted where the wrapper launches it.
LAUNCHES = 0

SOURCE = kernels.source_path("gather_u32.cu")
# gather_u32_launch(table, idx, out, n, cols, axis, mask, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]


def _check(table: torch.Tensor, idx: torch.Tensor, rows: int, cols: int, axis: int, mask: int) -> None:
    """Every masked index must land in the table whatever the data: a mask
    2^k - 1 below the table's rows (axis 0) or its columns (axis 1)."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if table.dtype != torch.int32 or idx.dtype != torch.int32 or table.dim() != 1:
        raise ValueError(f"expected a 1-D int32 table and int32 indices, got {table.dtype}{list(table.shape)} "
                         f"and {idx.dtype}")
    if idx.numel() != rows * cols or rows < 0 or cols < 1:
        raise ValueError(f"idx holds {idx.numel()} words, not rows * cols = {rows} * {cols}")
    if mask < 0 or mask & (mask + 1) or mask > 0x7FFFFFFF:
        raise ValueError(f"mask must be 2^k - 1 below 2^31, got {mask:#x}")
    reach = (mask + 1) * cols if axis == 0 else rows * cols
    if (axis == 1 and mask >= cols) or reach > table.numel():
        raise ValueError(f"mask {mask:#x} lets axis-{axis} indices of [{rows}, {cols}] leave a table of "
                         f"{table.numel()} words")


def _sources(idx: torch.Tensor, rows: int, cols: int, axis: int, mask: int) -> torch.Tensor:
    """i64[rows, cols] positions in the table of the words the gather reads."""
    k = (idx.reshape(rows, cols) & mask).to(torch.int64)
    if axis == 0:
        return k * cols + torch.arange(cols, device=idx.device)[None, :]
    return torch.arange(rows, device=idx.device)[:, None] * cols + k


def gather_u32_plain(table: torch.Tensor, idx: torch.Tensor, rows: int, cols: int, axis: int,
                     mask: int) -> torch.Tensor:
    """Plain PyTorch twin of gather_u32: i32[rows, cols] words of ``table``
    (u32 bits in int32) at the masked indices."""
    _check(table, idx, rows, cols, axis, mask)
    return table[_sources(idx, rows, cols, axis, mask)]


def gather_u32_cuda(table: torch.Tensor, idx: torch.Tensor, rows: int, cols: int, axis: int,
                    mask: int) -> torch.Tensor:
    """Launch gather_u32 on CUDA tensors; the shapes of :func:`gather_u32_plain`."""
    global LAUNCHES
    dev = idx.device
    if dev.type != "cuda" or table.device != dev:
        raise ValueError(f"gather_u32_cuda needs CUDA tensors on one device, got {table.device} and {dev}")
    _check(table, idx, rows, cols, axis, mask)
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    n = rows * cols
    if n >= 1 << 31:
        raise ValueError(f"{n} indices: the kernel takes fewer than 2^31")
    out = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    launch = kernels.load(SOURCE, "gather_u32_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, cols, axis, mask, stream)
    if err != 0:
        raise RuntimeError(f"gather_u32 kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def gather_u32(table: torch.Tensor, idx: torch.Tensor, rows: int, cols: int, axis: int, mask: int) -> torch.Tensor:
    """u32 gather: CUDA tensors launch the kernel, CPU tensors run the twin."""
    if idx.device.type == "cpu":
        return gather_u32_plain(table, idx, rows, cols, axis, mask)
    return gather_u32_cuda(table, idx, rows, cols, axis, mask)


def texel_indices(device="cuda", size: int = 512, max_depth: int = 10, seed: int = 0):
    """The texture words i32[T] and the merged texel-fetch indices
    i32[(max_depth - 1) * size^2] of one cornell-srgb sample (mallett, CIE
    1931, 4 hero wavelengths, explicit light sampling), as ``trace_lanes``
    fetches them, taken from its geometry phase by a hook around
    ``integrator._geometry_phase`` that is removed before returning."""
    from simple_spectral_torch.render import integrator
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    dev = resolve_device(device)
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=size, height=size, max_depth=max_depth)
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    captured = []
    geometry = integrator._geometry_phase

    def spy(*args, **kw):
        out = geometry(*args, **kw)
        captured.append(torch.cat(out[1].tex_idx))
        return out

    px = torch.arange(size * size, dtype=torch.int32, device=dev)
    integrator._geometry_phase = spy
    try:
        with torch.no_grad():
            integrator.trace_lanes(scene, tables, cfg, rnd.PRNGKey(seed), px % size, px // size)
    finally:
        integrator._geometry_phase = geometry
    return scene.texture, captured[0].to(torch.int32).contiguous()


def run(device="cuda", size: int = 512, max_depth: int = 10, seed: int = 0):
    """The entry point's path: the real merged texel indices and one gather
    of them.  Returns (texture, idx, out)."""
    table, idx = texel_indices(device, size, max_depth, seed)
    t = table.numel()
    if t & (t - 1):
        raise ValueError(f"the texture has {t} texels; the flat gather's mask needs a power of two")
    return table, idx, gather_u32(table, idx, idx.numel(), 1, 0, t - 1)


def variants(table: torch.Tensor, idx: torch.Tensor, lanes: int = N, seed: int = 0) -> list:
    """(label, table, idx, rows, cols, axis, mask) of every timed gather: the
    real texel indices over ``table``, then the spikes' shapes over a
    random table of T words."""
    dev = idx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    tab = torch.randint(0, 1 << 24, (T,), generator=gen, device=dev, dtype=torch.int32)
    rand = torch.randint(0, T, (D, lanes), generator=gen, device=dev, dtype=torch.int32)
    base = torch.arange(lanes, dtype=torch.int32, device=dev) // 64 * 64
    coh = (base[None, :] + torch.randint(0, 64, (D, lanes), generator=gen, device=dev, dtype=torch.int32)) % T
    r2, c2 = TABLE_2D
    head = torch.randint(0, T, (r2 * c2,), generator=gen, device=dev, dtype=torch.int32)
    out = [("real texel indices, cornell-srgb", table, idx, idx.numel(), 1, 0, table.numel() - 1)]
    for label, ind in (("flat take, random idx", rand), ("flat take, all-zero idx", torch.zeros_like(rand)),
                       ("flat take, coherent idx", coh)):
        out.append((label, tab, ind.reshape(-1).contiguous(), D * lanes, 1, 0, T - 1))
    out.append(("take_along_axis axis 0 [2048, 128]", tab, ((head >> 7) % r2).contiguous(), r2, c2, 0, r2 - 1))
    out.append(("take_along_axis axis 1 [2048, 128]", tab, (head & (c2 - 1)).contiguous(), r2, c2, 1, c2 - 1))
    return out


def library_call(table, idx, rows, cols, axis):
    """The one PyTorch call computing the same gather on the same indices
    (given as int64, which both calls require), for its time beside the
    kernel's."""
    idx64 = idx.reshape(rows, cols).to(torch.int64)
    if cols == 1:
        flat = idx64.reshape(-1)
        return lambda: torch.take(table, flat)
    table2d = table.reshape(-1, cols)
    return lambda: torch.gather(table2d, axis, idx64)


def bound(idx, rows, cols, axis, mask):
    """(ms, bound_by) of a gather: the indices and the output each crossing
    memory once, and of the table only the distinct words these indices
    reach."""
    words = int(torch.unique(_sources(idx, rows, cols, axis, mask)).numel())
    ms, by, _, _ = bound_ms(0, words * 4 + rows * cols * 8)
    return ms, by


def measure(table, idx, rows, cols, axis, mask, reps: int = 100) -> dict:
    """One gather held against its twin and the library call, and on the
    card timed beside both: the kernel and the library call on the card
    alone over ``reps`` launches, the twin host-inclusive (median of 30)."""
    got = gather_u32(table, idx, rows, cols, axis, mask)
    want = gather_u32_plain(table, idx, rows, cols, axis, mask)
    lib = library_call(table, idx, rows, cols, axis)
    ms_bound, by = bound(idx, rows, cols, axis, mask)
    rec = {"words_differ": int((got != want).sum()), "max_abs_err": int((got - want).abs().max()) if got.numel() else 0,
           "library_differs": int((lib().reshape(rows, cols) != want).sum()),
           "indices": rows * cols, "table_words": table.numel(), "bound_ms": ms_bound, "bound_by": by,
           "ms": None, "plain_ms": None, "library_ms": None}
    if idx.device.type == "cuda":
        rec["ms"] = cuda_time_ms(lambda: gather_u32_cuda(table, idx, rows, cols, axis, mask), reps)
        rec["plain_ms"] = host_inclusive_ms(lambda: gather_u32_plain(table, idx, rows, cols, axis, mask), 30)
        rec["library_ms"] = cuda_time_ms(lib, reps)
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=int, default=N, help="lanes per index row of the spikes' shapes")
    p.add_argument("--size", type=int, default=512, help="image side of the texel-index sample")
    p.add_argument("--max-depth", type=int, default=10)
    p.add_argument("--reps", type=int, default=100, help="launches timed back to back")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the twin; no times)")
    args = p.parse_args(argv)
    try:
        table, idx, _ = run(args.device, args.size, args.max_depth)
    except RuntimeError as e:
        print(f"bench_gather: {e}", file=sys.stderr)
        return 1
    records, ok = [], True
    for label, tab, ind, rows, cols, axis, mask in variants(table, idx, args.lanes):
        rec = dict(label=label, **measure(tab, ind, rows, cols, axis, mask, args.reps))
        ok = ok and rec["words_differ"] == 0 and rec["library_differs"] == 0
        times = ("kernel {ms:.4f} ms, torch {library_ms:.4f} ms (card alone), twin {plain_ms:.4f} ms "
                 "(host-inclusive)".format(**rec)
                 if rec["ms"] is not None else "times not measured (CPU)")
        print(f"{label:38s} {rows * cols:8d} idx: {times}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
              f"words apart from the twin {rec['words_differ']}, from torch {rec['library_differs']}")
        records.append(rec)
    print(json.dumps({"gather_u32": records}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
