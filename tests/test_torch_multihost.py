"""The port's multi-process layer (``simple_spectral_torch/parallel/multihost.py``)
on the CPU, without JAX.

1. In one process, ``render_accumulate_multihost`` is
   ``render_accumulate_sharded``'s chunk loop on the global mesh: equal bit
   for bit, with one chunk and with several.
2. A real 2-process gloo group: this file is its own worker (run as a
   script).  Both ranks render in two layouts in one group: 4 virtual CPU
   devices per process with sp = 2 (JAX's layout: each dp row inside one
   process, the dp gather across processes) and 1 device per process with
   sp = 2 (the one dp row spans both processes, whose partials meet in an
   ``all_reduce``).  Each rank's image equals the single-process render of
   the same mesh bit for bit (a two-term sum is the same either way round),
   and each rank's loss and gradients equal the single-device emulation
   within the dry run's bound (loss rtol 2e-5, scaled gradients atol 3e-5).

    python tests/test_torch_multihost.py <rank> <world> <port> <out.npz> <cpu|cuda>

``run_world`` and ``check_world`` also serve tests/test_torch_gpu.py, which
runs the same two layouts with one process per card through NCCL where a
machine has more than one card.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = dict(scene="cornell", mode="mallett", width=16, height=16, spp=4, max_depth=3)
TRAIN = dict(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=4, max_depth=3)
# (name, devices per process, sp) of the two-process run
LAYOUTS = (("dp-across", 4, 2), ("sp-across", 1, 2))
SEED = 7


def _setup(kw, device="cpu"):
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = RenderConfig(**kw)
    tables = build_color_tables(cfg, device=device)
    return cfg, build_scene(cfg, tables, device=device), tables


def _train_inputs():
    target = np.random.default_rng(SEED).uniform(0.0, 2.0, (64, 3)).astype(np.float32)
    return torch.arange(64, dtype=torch.int32), torch.from_numpy(target)


def _worker(rank: int, world: int, port: str, out_path: str, device: str) -> None:
    import time

    import torch.distributed as dist

    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.parallel.multihost import global_mesh, init_distributed, render_accumulate_multihost
    from simple_spectral_torch.parallel.sharding import sharded_loss_and_grad

    assert "jax" not in sys.modules and not any(m.startswith("simple_spectral_tpu") for m in sys.modules)
    torch.set_num_threads(1)
    assert init_distributed(f"localhost:{port}", world, rank, device=device)
    try:
        cfg, scene, tables = _setup(RENDER, device)
        t_cfg, t_scene, t_tables = _setup(TRAIN, device)
        px, target = (t.to(device) for t in _train_inputs())
        out = {}
        for name, local, sp in LAYOUTS:
            devices = [device] * local
            out[f"{name}/value"], out[f"{name}/alpha"] = render_accumulate_multihost(
                cfg, scene, tables, sp=sp, seed=SEED, local_devices=devices)
            mesh = global_mesh(sp, devices)
            loss, grads = sharded_loss_and_grad(t_scene, t_tables, t_cfg, mesh, rnd.PRNGKey(SEED), px, target,
                                                t_cfg.spp)
            out[f"{name}/loss"] = loss.cpu().numpy()
            out[f"{name}/mesh"] = np.array([mesh.shape["dp"], mesh.shape["sp"], mesh.procs_per_row])
            for f, g in grads.items():
                out[f"{name}/grad/{f}"] = g.cpu().numpy()
        if device == "cuda":
            # one 2^20-lane chunk's dp gather between the cards (host clock)
            mesh = global_mesh(1, [device])
            rows = {rank: torch.zeros((1 << 20, 4), dtype=torch.float32, device=device)}
            times = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mesh.gather_rows(rows)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out["gather_ms"] = np.array(sorted(times[1:])[5])
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank}: wrote {out_path}", flush=True)


def run_world(world: int, device: str, out_dir) -> list:
    """Spawn ``world`` processes of this file's worker on ``device`` (one
    card each through ``CUDA_VISIBLE_DEVICES`` for cuda) and return their
    results."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    outs = [os.path.join(str(out_dir), f"rank{i}.npz") for i in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), str(world), str(port), outs[i],
                               device], env=dict(env, CUDA_VISIBLE_DEVICES=str(i)) if device == "cuda" else env,
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(path) for path in outs]


def check_world(results: list, device: str) -> None:
    """Each rank's images equal the single-process render of the same mesh
    on ``device`` bit for bit, and its loss and gradients the single-device
    emulation within the dry run's bound."""
    from simple_spectral_torch import random as rnd
    from simple_spectral_torch.parallel import dryrun
    from simple_spectral_torch.parallel.sharding import emulated_loss_and_grad, make_mesh, render_accumulate_sharded

    world = len(results)
    cfg, scene, tables = _setup(RENDER, device)
    t_cfg, t_scene, t_tables = _setup(TRAIN, device)
    px, target = (t.to(device) for t in _train_inputs())
    for name, local, sp in LAYOUTS:
        dp = world * local // sp
        want_v, want_a = render_accumulate_sharded(cfg, scene, tables, make_mesh([device] * (world * local), sp=sp),
                                                   seed=SEED)
        loss1, grads1 = emulated_loss_and_grad(t_scene, t_tables, t_cfg, dp, sp, rnd.PRNGKey(SEED), px, target,
                                               t_cfg.spp)
        for got in results:
            assert list(got[f"{name}/mesh"]) == [dp, sp, max(1, sp // local)], name
            np.testing.assert_array_equal(got[f"{name}/value"], want_v, err_msg=name)
            np.testing.assert_array_equal(got[f"{name}/alpha"], want_a, err_msg=name)
            np.testing.assert_allclose(float(got[f"{name}/loss"]), float(loss1), rtol=dryrun.LOSS_RTOL, err_msg=name)
            for f, g1 in grads1.items():
                g1 = g1.cpu().numpy()
                scale = max(float(np.abs(g1).max()), 1e-8)
                np.testing.assert_allclose(got[f"{name}/grad/{f}"] / scale, g1 / scale, atol=dryrun.GRAD_ATOL,
                                           err_msg=f"{name} {f}")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def render_setup():
    return _setup(RENDER)


def test_global_mesh_shape():
    from simple_spectral_torch.parallel.multihost import global_mesh

    mesh = global_mesh(sp=2, local_devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2} and not mesh.distributed and mesh.procs_per_row == 1


def test_init_distributed_is_a_no_op_without_a_cluster(monkeypatch):
    import torch.distributed as dist

    from simple_spectral_torch.parallel.multihost import init_distributed, process_index

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized() and process_index() == 0
    with pytest.raises(ValueError, match="number of processes"):
        init_distributed("localhost:1", device="cpu")


@pytest.mark.parametrize("n_dev, sp, max_lanes", [(8, 2, 1 << 21), (2, 2, 128)], ids=["one-chunk", "two-chunks"])
def test_single_process_matches_sharded(render_setup, n_dev, sp, max_lanes):
    from simple_spectral_torch.parallel.multihost import render_accumulate_multihost
    from simple_spectral_torch.parallel.sharding import make_mesh, render_accumulate_sharded
    from simple_spectral_torch.render.renderer import render_chunk_lanes

    cfg, scene, tables = render_setup
    cfg = cfg.replace(max_lanes=max_lanes)
    dp = n_dev // sp
    assert -(-256 // min(256, render_chunk_lanes(cfg, scene) * dp)) == (1 if max_lanes > 128 else 2)
    v_mh, a_mh = render_accumulate_multihost(cfg, scene, tables, sp=sp, seed=SEED, local_devices=["cpu"] * n_dev)
    v_sh, a_sh = render_accumulate_sharded(cfg, scene, tables, make_mesh(["cpu"] * n_dev, sp=sp), seed=SEED)
    np.testing.assert_array_equal(v_mh, v_sh)
    np.testing.assert_array_equal(a_mh, a_sh)


def test_two_processes_over_gloo(tmp_path):
    check_world(run_world(2, "cpu", tmp_path), "cpu")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
