"""The train step over several cards, one process per card, one caller in a
closed loop: ``simple_spectral_torch.parallel.sharding.sharded_loss_and_grad``
on the (dp = world, sp = 1) mesh of ``parallel.multihost.global_mesh``,
NCCL between the processes (gloo on the CPU).

Each card renders ``lanes_per_pixel`` lanes of every pixel, ``spp`` samples
each; the loss and the gradients are all-reduced, and a step ends when rank
0 has the loss on the host.  Step i's key and the target are those of
``train_step``.  Rank 0 decides when the window ends and broadcasts the
decision before every step, so that every rank makes the same steps; it
times the steps and prints the line.

Traffic keys: those of ``train_step``; ``lanes_per_pixel`` counts per card,
and no forward-only step is traced.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import common
from benchmark.harness import Run
from benchmark.reference import steps as ref_steps

# Where a test plants a fault under the timed path (see train_step).
FAULT_HOOKS = (("simple_spectral_torch.parallel.sharding", "sharded_loss_and_grad", "train", 5),)


def reference_outputs(ctx, px, target, steps, world: int, shade_dtype=torch.float32) -> list:
    """The sum over the dp shards of the reference's (loss, grads) of each
    step given, on the inputs' device."""
    cfg, tables, scene = common.reference_state(ctx, px.device)
    spp, n = int(ctx.traffic["spp"]), px.shape[0]
    per = n // world
    out = []
    for i in steps:
        loss, grads = 0.0, None
        for di in range(world):
            sl, sg = ref_steps.shard_loss_and_grads(scene, tables, cfg, common.step_key(ctx.seed, i), di,
                                                    px[di * per:(di + 1) * per], target[di * per:(di + 1) * per],
                                                    spp, n, shade_dtype)
            loss = loss + sl
            grads = sg if grads is None else {f: grads[f] + sg[f] for f in grads}
        out.append((loss, grads))
    return out


def control(ctx) -> dict:
    """The control's numbers: the shards' sum of the reference with
    bfloat16 shading against the float32 one on the cell's first
    ``check_steps`` steps."""
    fields = common.render_fields(ctx)
    world = ctx.world or ctx.chips
    lanes = fields["width"] * fields["height"] * int(ctx.traffic["lanes_per_pixel"]) * world
    px, target = common.train_inputs(ctx.seed, fields["width"], fields["height"], lanes, torch.device(ctx.device))
    steps = list(range(int(ctx.traffic["check_steps"])))
    ref = reference_outputs(ctx, px, target, steps, world)
    loss_gap, grad_gap = common.train_gaps(reference_outputs(ctx, px, target, steps, world, torch.bfloat16), ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap}


def rank_main(ctx, rank: int, world: int, port: int):
    """One rank's run; rank 0 returns the :class:`Run`, the others None."""
    import torch.distributed as dist

    from simple_spectral_torch.parallel.multihost import global_mesh, init_distributed
    from simple_spectral_torch.parallel.sharding import sharded_loss_and_grad
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    t = ctx.traffic
    cuda = ctx.device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    init_distributed(f"localhost:{port}", world, rank, device=dev)
    try:
        mesh = global_mesh(1, [dev])
        cfg = common.program_config(ctx)
        tables = build_color_tables(cfg, device=dev)
        scene = build_scene(cfg, tables, device=dev)
        per = cfg.width * cfg.height * int(t["lanes_per_pixel"])
        spp = int(t["spp"])
        px, target = common.train_inputs(ctx.seed, cfg.width, cfg.height, per * world, dev)
        common.log(ctx, "tables, scene and inputs built")

        def step(i):
            loss, grads = sharded_loss_and_grad(scene, tables, cfg, mesh, common.step_key(ctx.seed, i), px, target,
                                                spp)
            return loss.item(), grads

        def go(flag: bool) -> bool:
            x = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
            dist.broadcast(x, 0)
            return bool(x.item())

        for i in range(int(t["warmup_calls"])):
            step(i)
        common.sync(dev)
        dist.barrier()
        run = Run(kind="train", setup_s=time.perf_counter() - ctx.t_start, device_kind=common.device_identity(dev),
                  device_count=world, facts={"k1_rays": per, "n_tris": scene.n_tris})
        common.log(ctx, "set-up done")
        if ctx.trace:
            n = int(t["trace_steps"])
            outs = common.traced(run, [(common.STEP_SPAN, lambda i=i: step(i)) for i in range(n)], common.STEP_SPAN,
                                 (common.STEP_SPAN,), lambda: [step(i) for i in range(n, 2 * n)])
            busy = torch.tensor([run.busy_s], dtype=torch.float64, device=dev)
            dist.all_reduce(busy)
            run.busy_s = float(busy) / world
            # the rank that joins a step's all-reduces last waits least in them
            nccl = torch.tensor(run.trace.nccl_us(common.STEP_SPAN), dtype=torch.float64, device=dev)
            dist.all_reduce(nccl, op=dist.ReduceOp.MIN)
            run.facts["nccl_us_least_rank"] = nccl.tolist()
        else:
            run.window_s, run.step_s, outs = common.window(step, ctx.seconds, go)
        checked = common.sample(ctx.seed, len(outs), int(t["check_steps"]))
        peak = torch.tensor([common.memory_peak(dev)], dtype=torch.int64, device=dev)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
        run.memory_peak_bytes = int(peak)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None
    common.log(ctx, f"{len(outs)} steps done")
    run.attempted = len(outs)
    run.failed = sum(not math.isfinite(loss) for loss, _ in outs)
    run.rays = float(len(outs) * per * world * spp * common.rays_per_sample(cfg))

    prog = [outs[i] for i in checked]
    del scene, tables, outs
    common.check_train(ctx, run, prog, lambda: reference_outputs(ctx, px, target, checked, world))
    return run


def run(ctx) -> Run:
    from benchmark import launch

    world = ctx.world or ctx.chips
    port = launch.free_port()
    ranks = launch.Ranks(ctx, world, port)
    try:
        result = rank_main(ctx, 0, world, port)
    except BaseException:
        ranks.kill()
        raise
    ranks.join()
    return result
