"""Rendering and training on a (dp, sp) grid of devices (PyTorch port of
``simple_spectral_tpu.parallel.sharding``).

The JAX package shards over a ``Mesh(("dp", "sp"))``: pixel lanes on ``dp``,
samples per pixel on ``sp``, a ``psum`` over ``sp`` of the partial sums, and
the gradients summed over the whole mesh.  PyTorch runs eagerly and has no
``shard_map``, so here a :class:`Mesh` is a grid of ``torch.device``s and the
shards run one after another in the calling process:

* shard (di, si) traces ``spp // sp`` samples of the di-th slice of the
  pixels, from the key ``fold_in(fold_in(key, di), si)`` split once per
  sample, exactly the JAX shard's stream;
* its partial sums add up over ``sp`` in shard order inside a process, and
  through ``torch.distributed.all_reduce`` on the row's process group where a
  dp row spans processes (``parallel/multihost.py``);
* the dp rows come back in order; a mesh over several processes gathers them
  with one ``all_gather`` of a fixed shape per call.

A device may repeat: ``make_mesh(["cpu"] * 8)`` is the counterpart of the
JAX tests' 8 virtual CPU devices, and ``[cuda:0] * 8`` lets one card run a
4x2 mesh shard by shard with the sample streams of eight chips.  Scene and
tables are replicated to every device of the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render.integrator import trace_lanes
from simple_spectral_torch.render.renderer import _render_chunk, render_chunk_lanes
from simple_spectral_torch.render.trainstep import _leaf_params, with_material_params
from simple_spectral_torch.scene.types import SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables
from simple_spectral_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A [dp, sp] grid of devices, and the part of it this process runs.

    ``devices[di][si]`` is the device of shard (di, si); on a mesh over
    several processes the other processes' entries are None.  The flat shard
    index ``di * sp + si`` runs process-major: process p owns the ``local``
    shards from ``p * local`` on.  Either a dp row lies inside one process
    (``local % sp == 0``) or it spans ``sp // local`` processes, whose
    ``row_group`` sums its partials.  ``distributed`` meshes gather their dp
    rows through the default process group."""

    devices: Tuple[Tuple[Optional[torch.device], ...], ...]
    rank: int = 0
    local: Optional[int] = None  # shards per process; None: all of them
    distributed: bool = False
    row_group: object = None  # the process group of this process's dp row, if it spans processes

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def _local(self) -> int:
        return self.local or len(self.devices) * len(self.devices[0])

    @property
    def procs_per_row(self) -> int:
        """Processes that one dp row spans (1 when it lies in one process)."""
        return max(1, self.shape["sp"] // self._local)

    @property
    def owned(self):
        """The (di, si) shards this process runs, in flat order."""
        sp = self.shape["sp"]
        first = self.rank * self._local
        return [divmod(f, sp) for f in range(first, first + self._local)]

    def rows(self):
        """{di: [si, ...]} of the shards this process runs, in order."""
        out = {}
        for di, si in self.owned:
            out.setdefault(di, []).append(si)
        return out

    def leads(self, di: int) -> bool:
        """Whether this process holds shard (di, 0): it reports row di's loss."""
        return (di, 0) in self.owned

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: its results land there."""
        di, si = self.owned[0]
        return self.devices[di][si]

    def gather_rows(self, rows: dict) -> torch.Tensor:
        """The rows' tensors [per, ...] of every process, concatenated in dp
        order.  One process: a concatenation.  Several: one ``all_gather``
        of this process's rows (a fixed shape: every process holds the same
        number) over the default group."""
        import torch.distributed as dist

        dp, sp = self.shape["dp"], self.shape["sp"]
        local = torch.cat([rows[di] for di in sorted(rows)])
        if not self.distributed:
            return local
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        per = rows[next(iter(rows))].shape[0]
        out = []
        for di in range(dp):
            p = di * sp // self._local  # the first process holding row di
            k = di - p * self._local // sp  # row di's place among process p's rows
            out.append(parts[p][k * per:(k + 1) * per])
        return torch.cat(out)


def local_device_list(devices: Optional[Sequence] = None) -> list:
    """``devices`` as ``torch.device``s; None: every local CUDA device, and
    without a card a RuntimeError, as ``resolve_device`` raises."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """Factor the devices into a (dp, sp) mesh.  Default: every local CUDA
    device, all on dp (pixel parallel); without a card that raises, as
    ``resolve_device`` does.  A list may repeat a device."""
    devices = local_device_list(devices)
    n = len(devices)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} devices")
    return Mesh(tuple(tuple(devices[d * sp:(d + 1) * sp]) for d in range(dp)))


def _pad_to(x: torch.Tensor, mult: int):
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)])
    return x, n


def _replicas(scene: SceneData, tables: ColorTables, mesh: Mesh) -> dict:
    """{device: (scene, tables)} for every device this process runs a shard
    on; the given objects where they already lie there."""
    out = {}
    for di, si in mesh.owned:
        dev = mesh.devices[di][si]
        if dev not in out:
            out[dev] = (scene, tables) if dev == scene.device else (scene.to(dev), tables.to(dev))
    return out


def _check(mesh: Mesh, n: int, spp: int) -> None:
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if n % dp or spp % sp:
        raise ValueError(f"{n} pixels must divide by dp={dp} and {spp} spp by sp={sp}")


def _sum_over_row(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A dp row's partial sum over the processes it spans (in place)."""
    if mesh.procs_per_row > 1:
        import torch.distributed as dist

        dist.all_reduce(t, group=mesh.row_group)
    return t


def sharded_sample_sums(scene: SceneData, tables: ColorTables, cfg: RenderConfig, mesh: Mesh, key,
                        px_flat: torch.Tensor, spp: int):
    """Per-pixel (sum over spp of value f32[N, 3], sum of alpha f32[N]),
    computed on the mesh, in dp order, on ``mesh.home``.

    Each (dp, sp) shard traces ``spp // sp`` samples for ``N // dp``
    pixels; the partial sums add up over ``sp``."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    n = px_flat.shape[0]
    _check(mesh, n, spp)
    per = n // dp
    home = mesh.home
    replicas = _replicas(scene, tables, mesh)
    rows = {}
    with torch.no_grad():
        for di, sis in mesh.rows().items():
            acc = None
            for si in sis:
                dev = mesh.devices[di][si]
                s, t = replicas[dev]
                kshard = rnd.fold_in(rnd.fold_in(key, di), si)
                v, a = _render_chunk(s, t, cfg, kshard, px_flat[di * per:(di + 1) * per].to(dev), spp // sp)
                part = torch.cat([v, a[:, None]], dim=1).to(home)
                acc = part if acc is None else acc + part
            rows[di] = _sum_over_row(mesh, acc)
    out = mesh.gather_rows(rows)
    return out[:, :3], out[:, 3]


def render_accumulate_sharded(cfg: RenderConfig, scene: SceneData, tables: ColorTables, mesh: Mesh, seed: int = 0):
    """Mesh-parallel version of ``render.renderer.render_accumulate``.

    Returns (value f64[H, W, 3], alpha f64[H, W]) as numpy, row 0 at the
    bottom."""
    w, h, spp = cfg.width, cfg.height, cfg.spp
    dp = mesh.shape["dp"]
    n_px = w * h
    key = rnd.PRNGKey(seed)
    # memory is O(lanes) per device: the chunk caps of render_chunk_lanes
    # hold per device
    px_per_chunk = min(n_px, render_chunk_lanes(cfg, scene) * dp)
    # a multiple of dp (JAX's rounding leaves 0 when n_px < dp; one padded
    # chunk then)
    px_per_chunk = max(dp, px_per_chunk - px_per_chunk % dp)

    value = np.zeros((n_px, 3), np.float64)
    alpha = np.zeros((n_px,), np.float64)
    for c in range((n_px + px_per_chunk - 1) // px_per_chunk):
        lo = c * px_per_chunk
        hi = min(lo + px_per_chunk, n_px)
        px, n_real = _pad_to(torch.arange(lo, hi, dtype=torch.int32, device=mesh.home), dp)
        sum_v, sum_a = sharded_sample_sums(scene, tables, cfg, mesh, rnd.fold_in(key, c), px, spp)
        value[lo:hi] = sum_v[:n_real].cpu().numpy().astype(np.float64) / spp
        alpha[lo:hi] = sum_a[:n_real].cpu().numpy().astype(np.float64) / spp
    return value.reshape(h, w, 3), alpha.reshape(h, w)


class _RowSum(torch.autograd.Function):
    """The sum of a dp row's partials over the processes it spans, whose
    backward hands the cotangent to this process's own partial unchanged.

    Every process of the row back-propagates the row's loss through its own
    samples only; the gradients' sum over all processes then counts each
    sample once.  (The JAX program back-propagates through the psum, which
    hands every shard a factor sp, and divides it out afterwards.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_over_row(mesh, x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sample_sum(scene, tables, cfg, key, px, n_samples: int) -> torch.Tensor:
    """Unrolled sum of ``n_samples`` samples' values, keys split from
    ``key`` and used in order (the JAX step unrolls too: transposing a scan
    costs more there)."""
    keys = rnd.split(key, n_samples)
    px_i, px_j = px % cfg.width, px // cfg.width
    sum_v = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=px.device)
    for i in range(n_samples):
        sum_v = sum_v + trace_lanes(scene, tables, cfg, keys[i], px_i, px_j).value
    return sum_v


def _grads_of(loss: torch.Tensor, params: dict) -> dict:
    with span("ss.backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {f: torch.zeros_like(p) if g is None else g for (f, p), g in zip(params.items(), grads)}


def sharded_loss_and_grad(scene: SceneData, tables: ColorTables, cfg: RenderConfig, mesh: Mesh, key,
                          px_flat: torch.Tensor, target: torch.Tensor, spp: int):
    """One differentiable training step on the mesh: the forward render, the
    L2 loss ``sum_dp sum((mean_v - target)^2) / (3 n)`` against a target
    image and its gradients with respect to the material tables
    (``DIFF_FIELDS``), summed over the whole mesh.

    Returns (loss scalar, grads dict shaped like the material tables), on
    ``mesh.home``; every process of a multi-process mesh gets both whole."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    n = px_flat.shape[0]
    _check(mesh, n, spp)
    per = n // dp
    home = mesh.home
    replicas = _replicas(scene, tables, mesh)
    params = _leaf_params(scene)
    with torch.enable_grad():
        on_dev = {dev: with_material_params(s, {f: p.to(dev) for f, p in params.items()})
                  for dev, (s, _) in replicas.items()}
        local = reported = None
        for di, sis in mesh.rows().items():
            sum_v = None
            for si in sis:
                dev = mesh.devices[di][si]
                kshard = rnd.fold_in(rnd.fold_in(key, di), si)
                part = _sample_sum(on_dev[dev], replicas[dev][1], cfg, kshard,
                                   px_flat[di * per:(di + 1) * per].to(dev), spp // sp).to(home)
                sum_v = part if sum_v is None else sum_v + part
            if mesh.procs_per_row > 1:
                sum_v = _RowSum.apply(sum_v, mesh)
            mean_v = sum_v / spp
            # mean over all pixels: the row's sum over the global count
            row = torch.sum((mean_v - target[di * per:(di + 1) * per].to(home)) ** 2) / (3.0 * n)
            local = row if local is None else local + row
            if mesh.leads(di):
                reported = row.detach() if reported is None else reported + row.detach()
        grads = _grads_of(local, params)
    if reported is None:
        reported = torch.zeros((), dtype=torch.float32, device=home)
    if mesh.distributed:
        import torch.distributed as dist

        dist.all_reduce(reported)
        for g in grads.values():
            dist.all_reduce(g)
    return reported, grads


def emulated_loss_and_grad(scene: SceneData, tables: ColorTables, cfg: RenderConfig, dp: int, sp: int, key,
                           px_flat: torch.Tensor, target: torch.Tensor, spp: int):
    """Single-device re-computation of :func:`sharded_loss_and_grad`'s
    value: the same per-(dp, sp)-shard fold_in streams, no mesh; the samples
    of a dp row add up in one running sum.  The dry run holds the sharded
    step to this to f32 reduction-order tolerance."""
    n = px_flat.shape[0]
    per = n // dp
    params = _leaf_params(scene)
    with torch.enable_grad():
        s2 = with_material_params(scene, params)
        loss = torch.zeros((), dtype=torch.float32, device=px_flat.device)
        for di in range(dp):
            px = px_flat[di * per:(di + 1) * per]
            px_i, px_j = px % cfg.width, px // cfg.width
            sum_v = torch.zeros((per, 3), dtype=torch.float32, device=px.device)
            for si in range(sp):
                kshard = rnd.fold_in(rnd.fold_in(key, di), si)
                for k in rnd.split(kshard, spp // sp):
                    sum_v = sum_v + trace_lanes(s2, tables, cfg, k, px_i, px_j).value
            mean_v = sum_v / spp
            loss = loss + torch.sum((mean_v - target[di * per:(di + 1) * per]) ** 2) / (3.0 * n)
        grads = _grads_of(loss, params)
    return loss.detach(), grads

