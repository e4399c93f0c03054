"""The control of a cell's check: the reference put in the program's place,
its shading one precision step below the configuration's float32
(bfloat16), compared with the float32 reference by the cell's own numbers.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

Prints one JSON line per seed with each compared number and its limit; a
sound check reads every control above a limit of it.  The benchmark's own
runs never run this: it gives a limit's upper reading (on the card, at the
cell's own size), and its test holds the control above the limits at a
small size on the CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common, harness  # noqa: E402


def control_gaps(ctx) -> dict:
    """{number: value} of the control on the inputs a run of the cell
    checks: the ``control(ctx)`` of the cell's entry module."""
    return importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}").control(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        ctx = harness.context(args.workload, seed, 0.0, False, device=args.device)
        gaps = control_gaps(ctx)
        limits = ctx.traffic["limits"]
        print(json.dumps({"workload": args.workload, "seed": seed, "device": common.device_identity(args.device),
                          "control": {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
