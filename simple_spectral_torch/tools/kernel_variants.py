"""Build variants of K2 and gather_u32, timed against the committed kernels
on one card.

    python -m simple_spectral_torch.tools.kernel_variants [--kernel k2|gather] [--parent DIR] [--reps 100]

Each variant is the committed CUDA source with one design choice undone
(:data:`VARIANTS`: old text -> new text), built by ``kernels.build`` beside
the committed kernel (its library is named by its own hash) and launched
through the same C interface as the wrapper.  With ``--parent`` the source
of another checkout (for instance ``git archive <commit>
simple_spectral_torch`` unpacked there) is one more variant.  All run in
one process on the same inputs (``tools.sweeps``): K2 on one sorted and one
unsorted 262144-lane bounce sweep of cornell-stress, gather_u32 on the real
texel indices and the spikes' shapes of ``bench_gather.variants``; each
output is held word for word against the plain twin, and each time is the
card's alone (``tools.cuda_time_ms``).  Prints the card's name and power
limit, then one JSON line per (input, variant); exits 1 if any output
differs.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

# Design choices of the committed kernels, each undone by text substitutions
# in the source.
VARIANTS = {
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


def variant_source(source: str, subs) -> str:
    """``source`` with each (old, new) of ``subs`` replaced; raises if an
    old text is not in it exactly once."""
    for old, new in subs:
        if source.count(old) != 1:
            raise ValueError(f"the variant's text {old!r} is not in the source exactly once")
        source = source.replace(old, new)
    return source


def _sources(kernel: str, parent=None) -> dict:
    """{variant name: source path}: the committed source first, then each
    variant written under the build directory, then the parent's."""
    from simple_spectral_torch import kernels

    base = kernels.source_path("cull_best.cu" if kernel == "k2" else "gather_u32.cu")
    out = {"committed": base}
    text = open(base).read()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    for name, subs in VARIANTS[kernel].items():
        path = os.path.join(kernels.BUILD_DIR, f"variant_{kernel}_{re.sub(r'[^a-z0-9]+', '_', name.lower())}.cu")
        with open(path, "w") as f:
            f.write(variant_source(text, subs))
        out[name] = path
    if parent is not None:
        out["parent"] = os.path.join(parent, "simple_spectral_torch", "csrc", os.path.basename(base))
    return out


def _cases(kernel: str, dev):
    """(input label, launch(fn) -> output, twin output) for every input."""
    import numpy as np
    import torch

    from simple_spectral_torch.tools import sweeps

    if kernel == "k2":
        from simple_spectral_torch.render import cull

        for sort in (True, False):
            a = sweeps.k2_bounce_sweep(dev, sort=sort)
            tiles, rays = a["tiles"], a["rays"]

            def launch(fn, a=a, tiles=tiles, rays=rays):
                out = torch.empty((2, rays.shape[1]), dtype=torch.int32, device=dev)
                err = fn(tiles.data_ptr(), tiles.shape[0], tiles.shape[1], tiles.shape[2], a["counts"].data_ptr(),
                         a["lists"].data_ptr(), a["entries"].data_ptr(), rays.data_ptr(), rays.shape[1],
                         a["n_valid"], float(np.float32(a["eps"])), out.data_ptr(), None,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"cull_best launch failed: cudaError_t {err}")
                return out

            want = cull.cull_best_plain(tiles, a["counts"], a["lists"], rays, a["eps"])
            yield f"{'sorted' if sort else 'unsorted'} bounce sweep, cornell-stress", launch, want
    else:
        from simple_spectral_torch.tools import bench_gather

        g = sweeps.texel_gather(dev)
        for label, tab, ind, rows, cols, axis, mask in bench_gather.variants(g["table"], g["idx"]):
            def launch(fn, tab=tab, ind=ind, rows=rows, cols=cols, axis=axis, mask=mask):
                out = torch.empty((rows, cols), dtype=torch.int32, device=dev)
                err = fn(tab.data_ptr(), ind.data_ptr(), out.data_ptr(), rows * cols, cols, axis, mask,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"gather_u32 launch failed: cudaError_t {err}")
                return out

            yield label, launch, bench_gather.gather_u32_plain(tab, ind, rows, cols, axis, mask)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", choices=sorted(VARIANTS), action="append",
                   help="k2 or gather (repeatable; default both)")
    p.add_argument("--parent", help="root of another checkout whose kernel source is one more variant")
    p.add_argument("--reps", type=int, default=100, help="launches timed back to back")
    args = p.parse_args(argv)
    import torch

    from simple_spectral_torch import kernels, resolve_device
    from simple_spectral_torch.render import cull
    from simple_spectral_torch.tools import bench_gather, card_line, cuda_time_ms

    try:
        dev = resolve_device("cuda")
    except RuntimeError as e:
        print(f"kernel_variants: {e}", file=sys.stderr)
        return 1
    print(card_line())
    ok = True
    for kernel in args.kernel or sorted(VARIANTS):
        paths = _sources(kernel, args.parent)
        kernels.build(*paths.values())
        fn_name, argtypes = (("cull_best_launch", cull._ARGTYPES) if kernel == "k2"
                             else ("gather_u32_launch", bench_gather._ARGTYPES))
        for label, launch, want in _cases(kernel, dev):
            for name, path in paths.items():
                fn = kernels.load(path, fn_name, argtypes)
                got = launch(fn)
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                ok = ok and equal
                ms = cuda_time_ms(lambda: launch(fn), args.reps)
                print(json.dumps({"kernel": kernel, "input": label, "variant": name, "ms": ms,
                                  "equal_to_twin": equal}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
