"""Weak-scaling efficiency of the sharded forward+backward step on the
port's mesh (PyTorch port of ``tools/scaling_bench.py``).

    python -m simple_spectral_torch.tools.scaling_bench [out.json] [--lanes-per-dev 4096] [--spp 4]
        [--equal-work] [--repeat R] [--worlds 1,2,4] [--device cpu]

The step is ``parallel/sharding.py`` ``sharded_loss_and_grad`` on the
canonical configuration (cornell-srgb 512x512, mallett, depth 10, explicit
light sampling, u32 texels) on a (dp = k, sp = 1) mesh: ``lanes_per_dev``
lanes per device, pixels ``arange(lanes) % (w * h)``, a zero target, and
the key ``fold_in(fold_in(PRNGKey(0), i), 0)`` for call i.  A call counts
``lanes * spp * (2 * max_depth - 1)`` rays (19 per sample at depth 10, as
bench.py counts them).  The tools' one timer (``tools.time_calls``) makes
2 warm-up calls, then K = 8 calls between a synchronize of every local card
before and after (and, in a process group, a collective that every rank
joins), timed on the host clock; in a group the slowest rank's time
counts.  Every shard's sweeps run kernel K1; each row gives K1's launches
per call.

Modes:

* weak scaling (the default): meshes over the first k devices, k in 1, 2,
  4, ... up to the devices present; ``efficiency = Mrays/s(k) / (k *
  Mrays/s(1))``.
* ``--equal-work``: the same total lanes once on a one-device mesh and once
  sharded over all n devices; ``sharded_over_single = Mrays/s(n) /
  Mrays/s(1)``.
* ``--repeat R``: the device list is R entries of one device (the first
  card, or the CPU).  A mesh whose devices repeat runs its shards one after
  another in this process, so ``--equal-work --repeat R`` measures what the
  port's in-process sharding costs by itself: R times the launches for the
  same device work.  It is the counterpart of the JAX tool's N virtual
  devices on one host.
* one process per card: inside a process group (``--coordinator
  host:port --num-processes N --process-id I``, or a launcher's
  ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) the tool
  measures the one mesh ``global_mesh()`` gives.  ``--worlds 1,2,4``
  launches those worlds one after another, w processes with one card each
  (``CUDA_VISIBLE_DEVICES``, NCCL; gloo with ``--device cpu``), and rates
  each against the first.

The JSON file has the JAX tool's fields, with ``"backend"`` the device type
and ``"device"`` the card's name and power limit (``tools.card_line``);
each row adds ``"processes"``, ``"k1_launches_per_call"`` and
``"seconds_per_call"``.  Numbers are written unrounded.

It runs on the card unless ``--device cpu`` is given; without a card, or
asked for more cards than are present, it exits non-zero.  On the CPU its
rates check the program and are not the card's.  ``--size`` and
``--max-depth`` cut the configuration to check the program at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.parallel.multihost import global_mesh, init_distributed
from simple_spectral_torch.parallel.sharding import local_device_list, make_mesh, sharded_loss_and_grad
from simple_spectral_torch.render import intersect_pallas as k1
from simple_spectral_torch.tools import time_calls, tool_device, write_json

WEAK_SIZES = (1, 2, 4, 8, 16, 32)
K_CALLS = 8
# a world that has not finished by then fails, with every process's output
WORLD_TIMEOUT_S = 900.0
# the checkout's root, put on the workers' path (the package is not installed)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rays_per_call(cfg: RenderConfig, lanes: int, spp: int) -> float:
    """Rays of one call, as the JAX tool and bench.py count them."""
    return float(lanes) * spp * (2 * cfg.max_depth - 1)


def step_inputs(cfg: RenderConfig, lanes: int, device):
    """The timed step's pixels (i32[lanes], wrapping over the image) and
    zero target (f32[lanes, 3])."""
    px = torch.arange(lanes, dtype=torch.int32, device=device) % (cfg.width * cfg.height)
    return px, torch.zeros((lanes, 3), dtype=torch.float32, device=device)


def call_key(i: int) -> torch.Tensor:
    """The key of call i.  The JAX tool folds in a chain token,
    ``int32(previous_loss * 1e-30)``, that keeps the TPU's remote runtime
    from pipelining calls; it is 0 for every finite loss, so the port folds
    in 0 and checks instead that every loss is finite."""
    return rnd.fold_in(rnd.fold_in(rnd.PRNGKey(0), i), 0)


def mesh_size(mesh) -> int:
    return mesh.shape["dp"] * mesh.shape["sp"]


def timed_step(cfg: RenderConfig, scene, tables, mesh, lanes_per_dev: int, spp: int):
    """The call :func:`bench_mesh` times, as a function of the call index:
    i -> (loss, grads) of ``sharded_loss_and_grad`` over ``lanes_per_dev``
    lanes per device of ``mesh``."""
    px, target = step_inputs(cfg, lanes_per_dev * mesh_size(mesh), mesh.home)

    def step(i: int):
        return sharded_loss_and_grad(scene, tables, cfg, mesh, call_key(i), px, target, spp)

    return step


def _barrier(mesh):
    """On a mesh over several processes, a collective that every rank joins
    (the fences of :func:`time_calls` wait for it); None otherwise."""
    if not mesh.distributed:
        return None

    def barrier():
        import torch.distributed as dist

        dist.all_reduce(torch.zeros(1, device=mesh.home))
        if mesh.home.type == "cuda":
            torch.cuda.synchronize(mesh.home)

    return barrier


def bench_mesh(cfg: RenderConfig, scene, tables, mesh, lanes_per_dev: int, spp: int, k_calls: int = K_CALLS) -> dict:
    """Time the step on ``mesh`` with ``tools.time_calls``: its warm-up
    calls, then ``k_calls`` between two fences of every card this process
    runs a shard on (and, in a group, a collective), on the host clock (the
    slowest rank's, in a group).  Returns {"mrays_per_s",
    "seconds_per_call", "k1_launches_per_call"}: K1's launches of one call
    on the whole mesh.  Raises if a loss or a gradient is not finite, or if
    the calls launched K1 a different number of times."""
    step = timed_step(cfg, scene, tables, mesh, lanes_per_dev, spp)
    res = time_calls(step, k_calls, [mesh.devices[di][si] for di, si in mesh.owned], barrier=_barrier(mesh))
    per_call, launches = res["seconds_per_call"], res["k1_launches_per_call"]
    if mesh.distributed:
        import torch.distributed as dist

        slowest = torch.tensor([per_call], dtype=torch.float64, device=mesh.home)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        total = torch.tensor([launches], dtype=torch.int64, device=mesh.home)
        dist.all_reduce(total)
        per_call, launches = float(slowest), int(total)
    lanes = lanes_per_dev * mesh_size(mesh)
    return {"mrays_per_s": rays_per_call(cfg, lanes, spp) / per_call / 1e6, "seconds_per_call": per_call,
            "k1_launches_per_call": launches}


def _say(label: str, lanes: int, res: dict) -> None:
    print(f"{f'{label} ({lanes} lanes)':44s} {res['seconds_per_call'] * 1e3:9.2f} ms/call  "
          f"{res['mrays_per_s']:8.3f} Mrays/s  K1 {res['k1_launches_per_call']} launches/call", flush=True)


def _rate_against_first(rows: list) -> None:
    """Each row's efficiency: its rate over the first row's, scaled by its
    devices over the first's (JAX's ``mrays / (k * base)`` when the first
    row has one device)."""
    base, base_k = rows[0]["mrays_per_s"], rows[0]["devices"]
    for r in rows:
        r["efficiency"] = r["mrays_per_s"] / (r["devices"] / base_k * base)


def weak_scaling(cfg: RenderConfig, scene, tables, devices: list, lanes_per_dev: int, spp: int) -> list:
    """Rows of the weak-scaling table: meshes over the first k of
    ``devices`` for each k of WEAK_SIZES up to the devices present."""
    rows = []
    for k in [k for k in WEAK_SIZES if k <= len(devices)]:
        res = bench_mesh(cfg, scene, tables, make_mesh(devices[:k], dp=k, sp=1), lanes_per_dev, spp)
        _say(f"dp={k}", lanes_per_dev * k, res)
        rows.append({"devices": k, "processes": 1, **res})
    _rate_against_first(rows)
    for r in rows:
        print(f"dp={r['devices']:3d}  {r['mrays_per_s']:10.2f} Mrays/s  eff {r['efficiency'] * 100:6.1f}%", flush=True)
    return rows


def equal_work(cfg: RenderConfig, scene, tables, devices: list, lanes_per_dev: int, spp: int) -> dict:
    """The same total lanes on a one-device mesh and sharded over all of
    ``devices``: the JAX tool's ``--equal-work`` fields."""
    n = len(devices)
    total = lanes_per_dev * n
    one = bench_mesh(cfg, scene, tables, make_mesh(devices[:1], dp=1, sp=1), total, spp)
    _say("dp=1", total, one)
    shd = bench_mesh(cfg, scene, tables, make_mesh(devices, dp=n, sp=1), lanes_per_dev, spp)
    _say(f"dp={n}", total, shd)
    m1, mn = one["mrays_per_s"], shd["mrays_per_s"]
    print(f"equal-work: 1-dev {m1:.3f} vs {n}-dev {mn:.3f} Mrays/s -> sharded/single ratio {mn / m1:.3f} "
          f"(1.0 = zero sharding overhead)", flush=True)
    return {"protocol": "equal-work sharding overhead", "total_lanes": total, "spp": spp,
            "sharded_over_single": mn / m1,
            "results": [{"devices": 1, "processes": 1, "lanes": total, **one},
                        {"devices": n, "processes": 1, "lanes": total, **shd}]}


def _child_argv(args, out: str, port: int, world: int, rank: int) -> list:
    argv = [sys.executable, "-m", "simple_spectral_torch.tools.scaling_bench", out,
            "--lanes-per-dev", str(args.lanes_per_dev), "--spp", str(args.spp), "--scene", args.scene,
            "--mode", args.mode, "--size", str(args.size), "--max-depth", str(args.max_depth),
            "--device", args.device, "--coordinator", f"localhost:{port}", "--num-processes", str(world),
            "--process-id", str(rank)]
    return argv + (["--repeat", str(args.repeat)] if args.repeat else [])


def run_world(args, world: int, cuda: bool) -> dict:
    """Launch ``world`` processes of this tool in one process group, one
    card each on the card (``CUDA_VISIBLE_DEVICES``), and return rank 0's
    row.  A process that fails, or a world that outlasts WORLD_TIMEOUT_S,
    raises with every process's output."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [subprocess.Popen(_child_argv(args, out, port, world, rank),
                                  env=dict(env, CUDA_VISIBLE_DEVICES=str(rank)) if cuda else env, cwd=_ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in range(world)]
        logs = [""] * world
        try:
            deadline = time.monotonic() + WORLD_TIMEOUT_S
            for rank, p in enumerate(procs):
                logs[rank] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0].decode(errors="replace")
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"the world of {world} outlasted {WORLD_TIMEOUT_S} s:\n" + "\n".join(logs))
        finally:
            for p in procs:
                p.kill()
                p.wait()
        failed = [rank for rank, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(f"--- rank {r} of the world of {world} exited {procs[r].returncode}:\n"
                                         f"{logs[r]}" for r in failed))
        print(logs[0], end="", flush=True)
        with open(out) as f:
            row = json.load(f)["results"][0]
    return dict(row, processes=world)


def _group_row(cfg, scene, tables, devices, args) -> tuple:
    """Inside a process group: the row of the mesh ``global_mesh()`` gives
    over every process's ``devices``, and this process's rank."""
    mesh = global_mesh(1, devices)
    res = bench_mesh(cfg, scene, tables, mesh, args.lanes_per_dev, args.spp)
    if mesh.rank == 0:
        _say(f"{mesh.shape['dp']} devices in {mesh.shape['dp'] // mesh.local} processes",
             args.lanes_per_dev * mesh_size(mesh), res)
    return {"devices": mesh_size(mesh), "processes": mesh_size(mesh) // mesh.local, **res}, mesh.rank


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--lanes-per-dev", type=int, default=4096)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--scene", default="cornell-srgb")
    p.add_argument("--mode", default="mallett")
    p.add_argument("--equal-work", action="store_true",
                   help="the same total lanes on a one-device mesh and sharded over all devices")
    p.add_argument("--repeat", type=int, default=None, metavar="R",
                   help="R entries of one device (the first card, or the CPU) as the device list")
    p.add_argument("--worlds", default=None, metavar="W,W,...",
                   help="launch worlds of W processes, one card each, one after another")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--size", type=int, default=512, help="image side")
    p.add_argument("--max-depth", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default); cpu only to check the program")
    args = p.parse_args(argv)

    dev = tool_device(args.device, "scaling_bench")
    if dev is None:
        return 1
    worlds = [int(w) for w in args.worlds.split(",")] if args.worlds else None
    if worlds and (args.equal_work or args.coordinator):
        p.error("--worlds measures whole worlds; it takes neither --equal-work nor --coordinator")
    cuda = dev.type == "cuda"
    if worlds and cuda and max(worlds) > torch.cuda.device_count():
        print(f"scaling_bench: a world of {max(worlds)} processes needs as many cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    head = {"backend": dev.type, "device": device_line(dev)}

    if worlds:
        if cuda:
            from simple_spectral_torch import kernels

            kernels.build(k1.SOURCE)  # once, before the processes that load it start
        rows = [run_world(args, w, cuda) for w in worlds]
        _rate_against_first(rows)
        for r in rows:
            print(f"world={r['processes']:3d}  dp={r['devices']:3d}  {r['mrays_per_s']:10.2f} Mrays/s  "
                  f"eff {r['efficiency'] * 100:6.1f}%", flush=True)
        result = dict(head, protocol="one process per card", lanes_per_dev=args.lanes_per_dev, spp=args.spp,
                      results=rows)
        return _write(args.out, result)

    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = RenderConfig(scene=args.scene, mode=args.mode, width=args.size, height=args.size, spp=64,
                       max_depth=args.max_depth)
    devices = (local_device_list() if cuda else [dev]) if args.repeat is None else \
        [local_device_list()[0] if cuda else dev] * args.repeat
    created = init_distributed(args.coordinator, args.num_processes, args.process_id, device=dev)
    import torch.distributed as dist

    grouped = dist.is_initialized()
    try:
        if grouped and args.equal_work:
            p.error("in a process group the tool measures the global mesh alone; --equal-work is for one process")
        tables = build_color_tables(cfg, device=devices[0])
        scene = build_scene(cfg, tables, device=devices[0])
        if grouped:
            row, rank = _group_row(cfg, scene, tables, devices, args)
            if rank != 0:
                return 0
            return _write(args.out, dict(head, lanes_per_dev=args.lanes_per_dev, spp=args.spp, results=[row]))
        if args.equal_work:
            return _write(args.out, dict(head, **equal_work(cfg, scene, tables, devices, args.lanes_per_dev,
                                                             args.spp)))
        rows = weak_scaling(cfg, scene, tables, devices, args.lanes_per_dev, args.spp)
        return _write(args.out, dict(head, lanes_per_dev=args.lanes_per_dev, spp=args.spp, results=rows))
    finally:
        if created:
            dist.destroy_process_group()


def _write(path, result: dict) -> int:
    write_json(path, result)
    if path:
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
