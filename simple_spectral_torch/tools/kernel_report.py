"""What a built kernel costs per (ray, triangle) test: its registers,
spills, residency and SASS, read from the built library on the card.

    python -m simple_spectral_torch.tools.kernel_report [--root DIR] [--sass-dir DIR]

For K1 (``csrc/intersect_best_key.cu``) and S1 (``csrc/bounce_fused.cu``) of
the checkout at ``--root`` (default this one), built by ``kernels.build``, it
prints per kernel function:

- registers, local (spill) bytes and static shared memory, and the CTAs of
  its block size that fit on one SM, all from libcuda
  (``cuFuncGetAttribute`` and ``cuOccupancyMaxActiveBlocksPerMultiprocessor``
  on the library's cubin, extracted with ``cuobjdump -xelf``; the block size
  is the function's ``__launch_bounds__``);
- the SASS of its triangle loop (``cuobjdump -sass``): the innermost loop
  with the most FP32 additions and multiplications, its instructions, the
  tests one iteration runs (those additions and multiplications over the 38
  of one test) and the instructions per test on the reject path (the loop
  less the spans that its forward branches skip where they hold none of
  the test's FP32 additions and multiplications: the candidate's division
  and key update);
- the issue floor at that count of K1's 262144-ray sweep over 38
  triangles, and of S1's two such sweeps per lane:
  instructions x tests over 128 thread-instructions per clock on each SM
  at the card's top SM clock (``nvidia-smi --query-gpu=clocks.max.sm``).

``--sass-dir`` writes each library's SASS there.  Needs a CUDA device and
``cuobjdump`` (beside ``nvcc``).
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

from simple_spectral_torch import kernels
from simple_spectral_torch.tools import OPS_PER_TRIANGLE_TEST

# thread-instructions an SM issues per clock: 4 schedulers, one warp each
ISSUE_PER_CLOCK_PER_SM = 128
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")
# a test's FP32 operations: -fmad=false leaves them unfused
_TEST_OPS = ("FADD", "FMUL")
# CU_FUNC_ATTRIBUTE_*
_MAX_THREADS, _SHARED, _LOCAL, _REGS = 0, 1, 3, 4


def parse_sass(text: str) -> dict:
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def _branch_target(text: str):
    """Address a BRA jumps to, or None."""
    if _opcode(text).split(".")[0] != "BRA":
        return None
    m = re.search(r"0x([0-9a-f]+)", text)
    return int(m.group(1), 16) if m else None


def triangle_loop(instrs: list):
    """The innermost loop with the most FP32 additions and multiplications:
    (first address, last address, its instructions), or None."""
    loops = []
    for addr, text in instrs:
        tgt = _branch_target(text)
        if tgt is not None and tgt <= addr:
            loops.append((tgt, addr))
    inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    best = None
    for lo, hi in inner:
        body = [(a, t) for a, t in instrs if lo <= a <= hi]
        fp = sum(_opcode(t).split(".")[0] in _TEST_OPS for _, t in body)
        if best is None or fp > best[3]:
            best = (lo, hi, body, fp)
    return None if best is None else best[:3]


def loop_cost(body: list) -> dict:
    """Instruction counts of one loop body: all of them, the reject path
    (less every span that a predicated forward branch inside the body
    skips, where the span holds none of the test's FP32 additions and
    multiplications: a candidate's division and key update), those
    additions and multiplications on that path and the tests they make."""
    hi = body[-1][0]
    skipped = set()
    for addr, text in body:
        tgt = _branch_target(text)
        if tgt is not None and addr < tgt <= hi and text.lstrip().startswith("@"):
            span = [(a, t) for a, t in body if addr < a < tgt]
            if not any(_opcode(t).split(".")[0] in _TEST_OPS for _, t in span):
                skipped.update(a for a, _ in span)
    path = [(a, t) for a, t in body if a not in skipped]
    fp = sum(_opcode(t).split(".")[0] in _TEST_OPS for _, t in path)
    tests = max(1, round(fp / OPS_PER_TRIANGLE_TEST))
    hist = {}
    for _, t in path:
        op = _opcode(t).split(".")[0]
        hist[op] = hist.get(op, 0) + 1
    return {"instructions": len(body), "reject_path": len(path), "fp_add_mul": fp, "tests": tests,
            "per_test": len(path) / tests, "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1]))}


class _LibCuda:
    """Just enough of libcuda to load a cubin and read a
    function's attributes and residency."""

    def __init__(self):
        import torch

        torch.cuda.init()
        self.cu = ctypes.CDLL("libcuda.so.1")
        self._check(self.cu.cuInit(0), "cuInit")
        dev = ctypes.c_int()
        self._check(self.cu.cuDeviceGet(ctypes.byref(dev), torch.cuda.current_device()), "cuDeviceGet")
        self.ctx = ctypes.c_void_p()
        self._check(self.cu.cuDevicePrimaryCtxRetain(ctypes.byref(self.ctx), dev), "cuDevicePrimaryCtxRetain")

    @staticmethod
    def _check(err, what):
        if err != 0:
            raise RuntimeError(f"{what} failed: CUresult {err}")

    def functions(self, cubin: bytes, names: list) -> dict:
        """{name: {block, shared, local, regs, ctas_per_sm}} of the functions
        of ``names`` that the cubin holds."""
        self._check(self.cu.cuCtxPushCurrent_v2(self.ctx), "cuCtxPushCurrent")
        mod = ctypes.c_void_p()
        try:
            if self.cu.cuModuleLoadData(ctypes.byref(mod), ctypes.c_char_p(cubin)) != 0:
                return {}  # a cubin without code for this card
            out = {}
            for name in names:
                fn = ctypes.c_void_p()
                if self.cu.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode()) != 0:
                    continue  # in another cubin of the library
                attr = {}
                for key, code in (("block", _MAX_THREADS), ("shared", _SHARED), ("local", _LOCAL), ("regs", _REGS)):
                    v = ctypes.c_int()
                    self._check(self.cu.cuFuncGetAttribute(ctypes.byref(v), code, fn), "cuFuncGetAttribute")
                    attr[key] = v.value
                ctas = ctypes.c_int()
                self._check(self.cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                    ctypes.byref(ctas), fn, attr["block"], ctypes.c_size_t(0)),
                    "cuOccupancyMaxActiveBlocksPerMultiprocessor")
                attr["ctas_per_sm"] = ctas.value
                out[name] = attr
            return out
        finally:
            if mod.value:
                self.cu.cuModuleUnload(mod)
            self.cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))


_libcuda = None


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def issue_floor_ms(per_test: float, tests: int, sms: int, clock_hz: float) -> float:
    """Least time to issue ``per_test`` instructions for each of ``tests``
    (ray, triangle) tests on ``sms`` SMs."""
    return per_test * tests / (ISSUE_PER_CLOCK_PER_SM * sms * clock_hz) * 1e3


def report(lib: str, match: str, tests: int, sass_path: str | None = None) -> list:
    """One record per kernel function of ``lib`` whose name holds
    ``match``: resources, residency, the triangle loop's cost and the issue
    floor of ``tests`` (ray, triangle) tests."""
    global _libcuda
    import torch

    cuobjdump = kernels.cuda_tool("cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    if sass_path:
        with open(sass_path, "w") as f:
            f.write(text)
    funcs = {k: v for k, v in parse_sass(text).items() if match in k}
    if _libcuda is None:
        _libcuda = _LibCuda()
    attrs = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([cuobjdump, "-xelf", "all", os.path.abspath(lib)], cwd=tmp, capture_output=True, check=True)
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            with open(cubin, "rb") as f:
                attrs.update(_libcuda.functions(f.read(), [n for n in funcs if n not in attrs]))
    missing = [n for n in funcs if n not in attrs]
    if missing:
        raise RuntimeError(f"no cubin of {lib} holds {missing}")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    clock = max_sm_clock_hz()
    out = []
    for name, instrs in funcs.items():
        rec = {"function": name, **attrs[name]}
        rec["warps_per_sm"] = rec["ctas_per_sm"] * rec["block"] // 32
        loop = triangle_loop(instrs)
        if loop is not None:
            cost = loop_cost(loop[2])
            rec.update({"loop": [hex(loop[0]), hex(loop[1])], **cost,
                        "issue_floor_ms": issue_floor_ms(cost["per_test"], tests, props.multi_processor_count, clock)})
        out.append(rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", help="root of the checkout whose K1 and S1 are read (default: this one)")
    p.add_argument("--sass-dir", help="write each library's SASS here")
    args = p.parse_args(argv)
    import torch

    from simple_spectral_torch.tools import card_line

    if not torch.cuda.is_available():
        print("kernel_report: no CUDA device is available", file=sys.stderr)
        return 1
    print(card_line())
    print(f"top SM clock {max_sm_clock_hz() / 1e6:.0f} MHz, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    csrc = os.path.join(os.path.abspath(args.root), "simple_spectral_torch", "csrc") if args.root else kernels.CSRC_DIR
    sources = [os.path.join(csrc, f) for f in ("intersect_best_key.cu", "bounce_fused.cu")]
    libs = kernels.build(*sources)
    if args.sass_dir:
        os.makedirs(args.sass_dir, exist_ok=True)
    # K1: a 262144-ray sweep over cornell's 38 triangles; S1: two such
    # sweeps per lane
    for src, lib, match, tests in zip(sources, libs, ("best_key_kernel", "bounce_kernel"),
                                      (262144 * 38, 2 * 262144 * 38)):
        sass_path = os.path.join(args.sass_dir, os.path.basename(lib) + ".sass") if args.sass_dir else None
        for rec in report(lib, match, tests, sass_path):
            print(json.dumps({"source": src, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
