"""Drive one cell the way ``run.py`` drives it, skipping only its look for a
card, and print its result line last: on the CPU at a tiny size, or with
``--device cuda --full`` on the card at the cell's own size.  A test plants
a fault of ``faults.py`` under the timed path of every process of the cell
through a ``sitecustomize`` on ``PYTHONPATH``.

    python benchmark/tests/drive.py --workload <name> --seed <n> [--world 2] [--device cuda --full]
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SHRINK = {"width": 8, "height": 8, "max_depth": 3}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--device", default="cpu")
    p.add_argument("--full", action="store_true", help="the cell's own size, not 8x8 at depth 3")
    args = p.parse_args()
    run = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device=args.device,
                           shrink=None if args.full else SHRINK, world=args.world)
    line = harness.report(harness.load_spec(), args.workload, run, bool(args.trace))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
