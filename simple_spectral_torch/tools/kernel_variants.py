"""Build variants of K1, K2, S1 and gather_u32, timed against the committed
kernels on one card.

    python -m simple_spectral_torch.tools.kernel_variants [--kernel k1|k2|s1|gather] [--parent DIR] [--reps 100]

Each variant is the committed CUDA source, with the headers it includes,
with one design choice undone (:data:`VARIANTS`: old text -> new text, each
old text found once in the source or one of its headers), written to its
own directory under the build directory, built by ``kernels.build`` beside
the committed kernel (its library is named by its own hash) and launched
through the same C interface as the wrapper.  With ``--parent`` the source
of another checkout (for instance ``git archive <commit>
simple_spectral_torch`` unpacked there) is one more variant; K1's C
interface changed with its six ray components, so the parent's K1 is timed
through its own checkout's ``intersect_best_key`` on the same V3 inputs
(its stacked copy of the rays included, as the render calls it) and
through its ``best_key_cuda`` on rays stacked once beforehand (the kernel
alone).  All run in one process on the same inputs (``tools.sweeps``): K1
on the main path's bounce sweep of cornell-srgb (exact and quantized keys,
and one ray, the fixed cost of a launch), K2 on one sorted and one
unsorted 262144-lane bounce sweep of cornell-stress, S1 on the fused
bounce's 262144 camera rays, gather_u32 on the real texel indices and the
spikes' shapes of ``bench_gather.variants``; each output is held against
the plain twin (word for word; S1's direction within ``WI_TOL``), and each
time is the card's alone (``tools.cuda_time_ms``).  For K1 and S1 it also
prints each build's registers, residency and SASS instructions per test
(``tools.kernel_report``).  Prints the card's name and power limit, then
one JSON line per (input, variant); exits 1 if any output differs.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys

# The source of each kernel, under csrc/.
SOURCES = {"k1": "intersect_best_key.cu", "k2": "cull_best.cu", "s1": "bounce_fused.cu", "gather": "gather_u32.cu"}

# Choices of the sweep K1 and S1 share (closest_hit.cuh): skipping the rest
# of a test when the whole warp has u and v of strictly opposite signs, where
# no clause of `inside` holds; branching to a candidate's division after
# each test rather than once per step; and the grid sized to what is
# resident, undone as one CTA per group of rays.
_EARLY_REJECT = [("  const float ww = ay[0] * ax[1] - ax[0] * ay[1];",
                  "  if (__all_sync(0xffffffffu, (u > 0.f && v < 0.f) || (u < 0.f && v > 0.f))) return false;\n"
                  "  const float ww = ay[0] * ax[1] - ax[0] * ay[1];")]
_BRANCH_PER_TEST = [("        any |= cand[s][q];",
                     "        if (cand[s][q]) keep_closest(t_scaled[s][q], det[s][q], idx_of(j + s), keep, eps, "
                     "best_bits[q], best_idx[q]);"),
                    ("    if (any) {", "    if (false) {")]
_ONE_CTA_PER_GROUP = [("  return min(groups, max(1, ctas_per_sm) * sms);", "  return groups;")]

# Design choices of the committed kernels, each undone by text substitutions
# in the source or a header it includes.
VARIANTS = {
    "k1": {
        "one ray per thread": [("constexpr int kRays = 2;", "constexpr int kRays = 1;")],
        "four rays per thread": [("constexpr int kRays = 2;", "constexpr int kRays = 4;"),
                                 ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")],
        "no unroll": [("constexpr int kUnroll = 2;     // triangles", "constexpr int kUnroll = 1;     // triangles")],
        "unroll by 4": [("constexpr int kUnroll = 2;     // triangles", "constexpr int kUnroll = 4;     // triangles")],
        "256-thread blocks": [("constexpr int kBlock = 128;", "constexpr int kBlock = 256;"),
                              ("constexpr int kMinBlocks = 8;", "constexpr int kMinBlocks = 4;")],
        "no register cap": [("__launch_bounds__(kBlock, kMinBlocks)\nbest_key_kernel",
                             "__launch_bounds__(kBlock)\nbest_key_kernel")],
        "packed-key compare": [("    if (bits < best_bits) {",
                                "    if (bits < best_bits || (bits == best_bits && idx < best_idx)) {")],
        "division branch per test": _BRANCH_PER_TEST,
        "128-triangle tile": [("constexpr int kTile = 64; ", "constexpr int kTile = 128;")],
        "one CTA per group of rays": _ONE_CTA_PER_GROUP,
        "early reject by warp vote": _EARLY_REJECT,
    },
    "s1": {
        "one lane per thread": [("constexpr int kLanes = 2;", "constexpr int kLanes = 1;")],
        "no unroll": [("constexpr int kUnroll = 2;     // rows", "constexpr int kUnroll = 1;     // rows")],
        "register cap for 12 CTAs per SM": [("__launch_bounds__(kBlock)\nbounce_kernel",
                                             "__launch_bounds__(kBlock, 12)\nbounce_kernel")],
        "register cap for 9 CTAs per SM": [("__launch_bounds__(kBlock)\nbounce_kernel",
                                            "__launch_bounds__(kBlock, 9)\nbounce_kernel")],
        "register cap for 8 CTAs per SM": [("__launch_bounds__(kBlock)\nbounce_kernel",
                                            "__launch_bounds__(kBlock, 8)\nbounce_kernel")],
        "division for every row": [
            ("  return inside && fabsf(det) > eps && same_sign && __float_as_int(c.y) != r.ign;",
             "  const float dist = t_scaled / (det == 0.f ? 1.0f : det);\n"
             "  return inside && fabsf(det) > eps && same_sign && __float_as_int(c.y) != r.ign && dist >= eps;")],
        "division branch per test": _BRANCH_PER_TEST,
        "early reject by warp vote": _EARLY_REJECT,
    },
    "k2": {
        "48 warps per SM (40 registers)": [("constexpr int kCtasPerSm = 8;", "constexpr int kCtasPerSm = 12;")],
        "40 warps per SM (48 registers)": [("constexpr int kCtasPerSm = 8;", "constexpr int kCtasPerSm = 10;")],
        "always lane-parallel rows": [("constexpr int kRowParallelMax = 20;", "constexpr int kRowParallelMax = 0;")],
        "row-parallel up to 8 live lanes": [("constexpr int kRowParallelMax = 20;",
                                             "constexpr int kRowParallelMax = 8;")],
        "always row-parallel rows": [("constexpr int kRowParallelMax = 20;", "constexpr int kRowParallelMax = 32;")],
    },
    "gather": {
        "16 words per thread": [("constexpr int kPerThread = 8;", "constexpr int kPerThread = 16;")],
        "4 words per thread": [("constexpr int kPerThread = 8;", "constexpr int kPerThread = 4;")],
        "256-thread blocks": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
                              ("constexpr int kBlocksPerSm = 16;", "constexpr int kBlocksPerSm = 8;")],
        "no L2 policy on the table": [
            ('asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));',
             "v = __ldg(p);")],
        "streaming (.cs) indices and outputs": [("k[l] = q < n4 ? __ldg(idx + q)", "k[l] = q < n4 ? __ldcs(idx + q)"),
                                                ("if (q < n4) out[q] = v[l];", "if (q < n4) __stcs(out + q, v[l]);")],
    },
}
# launch function, kernel-name fragment (for kernel_report) of each kernel
_LAUNCH = {"k1": "intersect_best_key_launch", "k2": "cull_best_launch", "s1": "bounce_fused_launch",
           "gather": "gather_u32_launch"}
_FUNCTION = {"k1": "best_key_kernel", "s1": "bounce_kernel"}


def source_texts(kernel: str) -> dict:
    """{file name: text} of the kernel's committed source and the headers
    it includes, the source first."""
    from simple_spectral_torch import kernels

    src = kernels.source_path(SOURCES[kernel])
    out = {}
    for path in (src, *kernels.includes(src)):
        with open(path) as f:
            out[os.path.basename(path)] = f.read()
    return out


def variant_texts(texts: dict, subs) -> dict:
    """``texts`` with each (old, new) of ``subs`` replaced; raises if an old
    text is not in them exactly once."""
    texts = dict(texts)
    for old, new in subs:
        where = [name for name, text in texts.items() for _ in range(text.count(old))]
        if len(where) != 1:
            raise ValueError(f"the variant's text {old!r} is not in the sources exactly once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def _sources(kernel: str, parent=None) -> dict:
    """{variant name: source path}: the committed source first, then each
    variant written to its own directory under the build directory, then
    the parent's (K1's parent is timed through its package instead)."""
    from simple_spectral_torch import kernels

    base = kernels.source_path(SOURCES[kernel])
    out = {"committed": base}
    texts = source_texts(kernel)
    for name, subs in VARIANTS[kernel].items():
        folder = os.path.join(kernels.BUILD_DIR, f"variant_{kernel}_{re.sub(r'[^a-z0-9]+', '_', name.lower())}")
        os.makedirs(folder, exist_ok=True)
        for fname, text in variant_texts(texts, subs).items():
            with open(os.path.join(folder, fname), "w") as f:
                f.write(text)
        out[name] = os.path.join(folder, SOURCES[kernel])
    if parent is not None and kernel != "k1":
        out["parent"] = os.path.join(parent, "simple_spectral_torch", "csrc", SOURCES[kernel])
    return out


def _parent_k1(parent: str):
    """The parent checkout's K1 module, building its own source."""
    path = os.path.join(parent, "simple_spectral_torch", "render", "intersect_pallas.py")
    spec = importlib.util.spec_from_file_location("parent_intersect_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(parent, "simple_spectral_torch", "csrc", SOURCES["k1"])
    return mod


def _cases(kernel: str, dev):
    """(input label, launch(fn) -> output, check(output) -> bool, kwargs)
    for every input; kwargs are the wrapper's arguments (K1's and S1's)."""
    import numpy as np
    import torch

    from simple_spectral_torch.tools import sweeps

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if kernel == "k1":
        from simple_spectral_torch.render import intersect_pallas as k1

        a = sweeps.k1_bounce_sweep(dev)
        for exact, n in ((True, None), (False, None), (True, 1)):
            kw = dict(a, exact=exact)
            if n is not None:
                kw.update(o=type(a["o"])(*(c[:n] for c in a["o"])), d=type(a["d"])(*(c[:n] for c in a["d"])),
                          ignore_prim=a["ignore_prim"][:n])
            tris = kw["tri_verts"].reshape(-1, 9).contiguous()
            rays_n = kw["o"].x.shape[0]

            def launch(fn, kw=kw, tris=tris, rays_n=rays_n):
                out = torch.empty((rays_n,), dtype=torch.int64 if kw["exact"] else torch.int32, device=dev)
                err = fn(*(c.data_ptr() for c in (*kw["o"], *kw["d"])), kw["ignore_prim"].data_ptr(), tris.data_ptr(),
                         kw["tri_prim"].data_ptr(), out.data_ptr(), rays_n, tris.shape[0],
                         k1.key_idx_mask(tris.shape[0]), float(np.float32(kw["eps"])), int(kw["exact"]), stream())
                if err != 0:
                    raise RuntimeError(f"intersect_best_key launch failed: cudaError_t {err}")
                return out

            want = k1.best_key_plain(**kw)
            label = f"{'exact' if exact else 'quantized'} key, bounce sweep of cornell-srgb, N={rays_n}"
            yield label, launch, (lambda got, want=want: bool(torch.equal(got, want))), kw
    elif kernel == "s1":
        from simple_spectral_torch.tools import bench_megakernel as s1

        a = sweeps.s1_bounce(dev)

        def launch(fn, a=a):
            out = torch.empty((8, a["rays"].shape[1]), dtype=torch.float32, device=dev)
            err = fn(a["rows"].data_ptr(), a["light"].data_ptr(), a["rays"].data_ptr(), a["u"].data_ptr(),
                     out.data_ptr(), a["rays"].shape[1], stream())
            if err != 0:
                raise RuntimeError(f"bounce_fused launch failed: cudaError_t {err}")
            return out

        want = s1.bounce_plain(**a)

        def check(got, want=want):
            diff = s1.compare(got, want)
            return diff["dist_prim_bits_differ"] == 0 and diff["wi_ndl_max_abs_err"] <= s1.WI_TOL

        yield f"fused bounce, {a['rays'].shape[1]} camera rays of cornell", launch, check, a
    elif kernel == "k2":
        from simple_spectral_torch.render import cull

        for sort in (True, False):
            a = sweeps.k2_bounce_sweep(dev, sort=sort)
            tiles, rays = a["tiles"], a["rays"]

            def launch(fn, a=a, tiles=tiles, rays=rays):
                out = torch.empty((2, rays.shape[1]), dtype=torch.int32, device=dev)
                err = fn(tiles.data_ptr(), tiles.shape[0], tiles.shape[1], tiles.shape[2], a["counts"].data_ptr(),
                         a["lists"].data_ptr(), a["entries"].data_ptr(), rays.data_ptr(), rays.shape[1],
                         a["n_valid"], float(np.float32(a["eps"])), out.data_ptr(), None, stream())
                if err != 0:
                    raise RuntimeError(f"cull_best launch failed: cudaError_t {err}")
                return out

            want = cull.cull_best_plain(tiles, a["counts"], a["lists"], rays, a["eps"])
            yield (f"{'sorted' if sort else 'unsorted'} bounce sweep, cornell-stress", launch,
                   (lambda got, want=want: bool(torch.equal(got, want))), a)
    else:
        from simple_spectral_torch.tools import bench_gather

        g = sweeps.texel_gather(dev)
        for label, tab, ind, rows, cols, axis, mask in bench_gather.variants(g["table"], g["idx"]):
            def launch(fn, tab=tab, ind=ind, rows=rows, cols=cols, axis=axis, mask=mask):
                out = torch.empty((rows, cols), dtype=torch.int32, device=dev)
                err = fn(tab.data_ptr(), ind.data_ptr(), out.data_ptr(), rows * cols, cols, axis, mask, stream())
                if err != 0:
                    raise RuntimeError(f"gather_u32 launch failed: cudaError_t {err}")
                return out

            want = bench_gather.gather_u32_plain(tab, ind, rows, cols, axis, mask)
            yield label, launch, (lambda got, want=want: bool(torch.equal(got, want))), None


def _argtypes(kernel: str):
    from simple_spectral_torch.render import cull, intersect_pallas
    from simple_spectral_torch.tools import bench_gather, bench_megakernel

    return {"k1": intersect_pallas, "k2": cull, "s1": bench_megakernel, "gather": bench_gather}[kernel]._ARGTYPES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=sorted(VARIANTS), action="append",
                   help="k1, k2, s1 or gather (repeatable; default all)")
    p.add_argument("--parent", help="root of another checkout whose kernel source is one more variant")
    p.add_argument("--reps", type=int, default=100, help="launches timed back to back")
    args = p.parse_args(argv)
    import torch

    from simple_spectral_torch import kernels, resolve_device
    from simple_spectral_torch.tools import card_line, cuda_time_ms, kernel_report

    try:
        dev = resolve_device("cuda")
    except RuntimeError as e:
        print(f"kernel_variants: {e}", file=sys.stderr)
        return 1
    print(card_line())
    ok = True
    for kernel in args.kernel or sorted(VARIANTS):
        paths = _sources(kernel, args.parent)
        libs = dict(zip(paths, kernels.build(*paths.values())))
        if kernel in _FUNCTION:
            if kernel == "k1" and args.parent:
                libs["parent"] = kernels.build(os.path.join(args.parent, "simple_spectral_torch", "csrc",
                                                            SOURCES[kernel]))[0]
            tests = 262144 * 38 * (2 if kernel == "s1" else 1)
            for name, lib in libs.items():
                for rec in kernel_report.report(lib, _FUNCTION[kernel], tests):
                    rec.pop("opcodes", None)
                    print(json.dumps({"kernel": kernel, "variant": name, "resources": rec}), flush=True)
        parent_k1 = _parent_k1(args.parent) if kernel == "k1" and args.parent else None
        for label, launch, check, kw in _cases(kernel, dev):
            runs = {name: (lambda fn=kernels.load(path, _LAUNCH[kernel], _argtypes(kernel)): launch(fn))
                    for name, path in paths.items()}
            if kernel == "k1":
                from simple_spectral_torch.render import intersect_pallas as k1

                runs["committed, as called"] = lambda: k1.intersect_best_key(**kw)
                if parent_k1 is not None:
                    rays = torch.stack([*kw["o"], *kw["d"]])
                    tris = kw["tri_verts"].reshape(-1, 9).contiguous()
                    runs["parent, as called"] = lambda: parent_k1.intersect_best_key(**kw)
                    runs["parent"] = lambda rays=rays, tris=tris: parent_k1.best_key_cuda(
                        rays, kw["ignore_prim"], tris, kw["tri_prim"], kw["eps"], kw["exact"])
            for name, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                equal = check(got)
                ok = ok and equal
                ms = cuda_time_ms(run, args.reps)
                print(json.dumps({"kernel": kernel, "input": label, "variant": name, "ms": ms,
                                  "equal_to_twin": equal}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
