"""Rendering across processes (PyTorch port of
``simple_spectral_tpu.parallel.multihost``).

Every process calls :func:`init_distributed`, builds the same global mesh
with :func:`global_mesh` (each process's devices laid out process-major, so
a process owns contiguous dp rows), renders only its own shards, and every
process assembles the full image: the dp rows of each chunk travel in one
``all_gather`` of a fixed shape.  Where ``sp`` exceeds a process's devices,
a dp row spans several processes and its partial sums meet in an
``all_reduce`` on that row's process group.

Backends: NCCL for a mesh of CUDA devices, gloo for a mesh on the CPU.  NCCL
refuses two ranks on one card, so on a machine with one card more than one
rank runs on the CPU only; one card still runs a world of one through NCCL.
Nothing here reads a cluster's layout: the caller gives the coordinator's
address, the number of processes and this process's index, or runs under a
launcher that sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.parallel.sharding import Mesh, local_device_list, make_mesh, render_accumulate_sharded
from simple_spectral_torch.scene.types import SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables

# a lost peer fails a collective after this long instead of hanging
TIMEOUT_S = 300.0


def _launcher_env() -> bool:
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> bool:
    """Join the process group of a multi-process render.

    A no-op (returns False) when no argument and no launcher environment is
    given, so entry points may call it unconditionally, and when this
    process already belongs to a group of ``num_processes``.  The backend
    follows ``device``: NCCL for CUDA, gloo for the CPU.  Returns True when
    this call created the group: the caller then destroys it
    (``torch.distributed.destroy_process_group``)."""
    import torch.distributed as dist

    if coordinator is None and num_processes is None and not _launcher_env():
        return False
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        if num_processes is not None and dist.get_world_size() != num_processes:
            raise RuntimeError(f"already in a process group of {dist.get_world_size()}, not {num_processes}")
        if dist.get_backend() != backend:
            raise RuntimeError(f"already in a {dist.get_backend()} process group; a {device} mesh needs {backend}")
        return False
    if coordinator is None:
        init_method, world, rank = "env://", num_processes, process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs the number of processes and this process's id")
        init_method, world, rank = f"tcp://{coordinator}", num_processes, process_id
    dist.init_process_group(backend, init_method=init_method, world_size=world if world is not None else -1,
                            rank=rank if rank is not None else -1,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(sp: int = 1, local_devices: Optional[Sequence] = None) -> Mesh:
    """The (dp, sp) mesh over every device of every process.

    ``local_devices`` are this process's (default: every local CUDA
    device); every process must bring as many.  Outside a process group
    this is ``make_mesh(local_devices, sp=sp)``.  In one, the flat shard
    order is process-major, so each process's shards are contiguous: a dp
    row either lies inside one process or spans ``sp // len(local_devices)``
    of them, and then gets a process group for its sum over sp."""
    import torch.distributed as dist

    local = local_device_list(local_devices)
    if not dist.is_initialized():
        return make_mesh(local, sp=sp)
    want = "nccl" if local[0].type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(f"a mesh of {local[0].type} devices needs the {want} backend, not {dist.get_backend()}")
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [torch.zeros(1, dtype=torch.int64, device=local[0]) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64, device=local[0]))
    if any(int(c) != len(local) for c in counts):
        raise ValueError(f"every process must bring the same number of devices, got {[int(c) for c in counts]}")
    n_local, n = len(local), len(local) * world
    if n % sp:
        raise ValueError(f"mesh {n // sp}x{sp} != {n} devices")
    if n_local % sp and sp % n_local:
        raise ValueError(f"sp={sp} neither divides nor is a multiple of the {n_local} devices of each process")
    flat = [None] * n
    flat[rank * n_local:(rank + 1) * n_local] = local
    row_group = None
    per_row = sp // n_local
    if per_row > 1:
        # every process takes part in creating every group, in the same order
        for r in range(world // per_row):
            group = dist.new_group(list(range(r * per_row, (r + 1) * per_row)))
            if rank // per_row == r:
                row_group = group
    dp = n // sp
    return Mesh(tuple(tuple(flat[d * sp:(d + 1) * sp]) for d in range(dp)), rank=rank, local=n_local,
                distributed=True, row_group=row_group)


def render_accumulate_multihost(cfg: RenderConfig, scene: SceneData, tables: ColorTables, sp: int = 1,
                                seed: int = 0, local_devices: Optional[Sequence] = None):
    """Mesh-parallel render across every process; each returns the full
    (value f64[H, W, 3], alpha f64[H, W]) image, row 0 at the bottom.

    It is ``render_accumulate_sharded``'s chunk loop on the global mesh:
    each process renders its own shards of every chunk, and the chunk's dp
    rows come back from every process in one ``all_gather``."""
    return render_accumulate_sharded(cfg, scene, tables, global_mesh(sp, local_devices), seed=seed)
