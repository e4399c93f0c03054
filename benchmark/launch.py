"""One process per card for a cell over several cards.

The process that runs the cell is rank 0; :func:`spawn` starts ranks 1 ..
world - 1 as ``python -m benchmark.launch <json>``, rank r seeing one card,
the r-th of those this process sees (:func:`card_of`), with the rendezvous
at ``localhost`` on a free port (the pattern of the port's
``tools/scaling_bench.run_world``).  Each rank fails, as rank 0 does, if
its process holds a forbidden module once its steps are done.  Their
output goes to this process's standard error, line by line, under their
rank.  :class:`Ranks` watches them: a rank that exits with an error ends the
run at once with exit code 1, so that no rank waits for it in a collective.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

from benchmark import harness

# A rank that has not exited this long after rank 0's last collective has hung.
JOIN_TIMEOUT_S = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_of(rank: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` of a rank's process: the rank-th entry of
    this process's list, or the rank itself where no list is set, so that
    every rank stays on the cards that the run was given."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return str(rank)
    cards = [c.strip() for c in visible.split(",") if c.strip()]
    if rank >= len(cards):
        raise RuntimeError(f"rank {rank} has no card: CUDA_VISIBLE_DEVICES={visible!r}")
    return cards[rank]


class Ranks:
    """Ranks 1 .. world - 1 of a cell, started at construction."""

    def __init__(self, ctx, world: int, port: int):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (harness.ROOT, os.environ.get("PYTHONPATH")) if p))
        self.procs, self.relays = [], []
        for rank in range(1, world):
            args = {"workload": ctx.workload, "seed": ctx.seed, "seconds": ctx.seconds, "trace": ctx.trace,
                    "device": ctx.device, "shrink": ctx.shrink, "rank": rank, "world": world, "port": port}
            child_env = dict(env, CUDA_VISIBLE_DEVICES=card_of(rank)) if ctx.device == "cuda" else env
            p = subprocess.Popen([sys.executable, "-m", "benchmark.launch", json.dumps(args)], cwd=harness.ROOT,
                                 env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            relay = threading.Thread(target=self._relay, args=(rank, p), daemon=True)
            relay.start()
            self.procs.append(p)
            self.relays.append(relay)
        self._stop = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    @staticmethod
    def _relay(rank: int, p) -> None:
        for line in iter(p.stdout.readline, b""):
            sys.stderr.write(f"[rank {rank}] {line.decode(errors='replace')}")
        sys.stderr.flush()

    def _failed(self):
        return [(r + 1, p.returncode) for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]

    def _watchdog(self) -> None:
        while not self._stop.wait(0.5):
            failed = self._failed()
            if failed:
                self.kill()
                for relay in self.relays:
                    relay.join(timeout=5.0)
                print(f"benchmark: rank(s) {failed} failed; the run fails", file=sys.stderr, flush=True)
                os._exit(1)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self) -> None:
        """Wait for every rank to exit; raise if one failed or hung."""
        self._stop.set()
        self._watch.join()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a rank did not exit within {JOIN_TIMEOUT_S} s")
        finally:
            self.kill()
            for relay in self.relays:
                relay.join(timeout=5.0)
        failed = self._failed()
        if failed:
            raise RuntimeError(f"rank(s) {failed} failed")


def main(argv=None) -> int:
    args = json.loads((argv or sys.argv[1:])[0])
    ctx = harness.context(args["workload"], args["seed"], args["seconds"], args["trace"], device=args["device"],
                          shrink=args["shrink"], world=args["world"])
    entry = importlib.import_module(f"benchmark.entries.{ctx.traffic['entry']}")
    entry.rank_main(ctx, args["rank"], args["world"], args["port"])
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark: rank {args['rank']} holds forbidden modules {found}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
