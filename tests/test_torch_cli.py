"""The port's command line: its flag surface against the JAX package's, tiny
renders on the CPU through its progressive path, on a mesh and across a
process group, and a run in a process where ``jax`` and
``simple_spectral_tpu`` cannot be imported.  tests/test_torch_progressive.py holds its images and metrics
against the JAX package's CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from simple_spectral_torch.cli import build_parser, main
from simple_spectral_tpu.cli import build_parser as j_build_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["-s", "cornell", "-w", "8", "-h", "8", "-spp", "1", "--mode", "rgb", "--max-depth", "2", "--quiet"]


def test_flag_surface_is_the_jax_cli_plus_device():
    ours = {a.dest for a in build_parser()._actions}
    theirs = {a.dest for a in j_build_parser()._actions}
    assert ours - theirs == {"device"}
    assert theirs - ours == set()
    a = build_parser().parse_args(["-h", "96", "--samples", "3", "-io"])
    assert (a.height, a.spp, a.indirect_only, a.device) == (96, 3, True, "cuda")


def test_device_cpu_writes_a_png(tmp_path):
    out = tmp_path / "t.png"
    assert main(TINY + ["-o", str(out), "--device", "cpu"]) == 0
    im = np.asarray(Image.open(out))
    assert im.shape == (8, 8, 4) and im.dtype == np.uint8
    assert im[..., :3].max() > 0 and im[2:6, 2:6, 3].min() == 255  # the centre sees the box


def test_sharded_flag_renders_on_a_cpu_mesh(tmp_path):
    """``--sharded`` on ``--device cpu`` renders its passes on the one-device
    mesh: its checkpoint, resumed by ``ProgressiveRenderer(mesh=make_mesh(["cpu"]))``
    (the mesh is part of the fingerprint), holds that renderer's own mean bit
    for bit."""
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.parallel import make_mesh
    from simple_spectral_torch.render.progressive import ProgressiveRenderer

    out, ckpt = tmp_path / "t.png", str(tmp_path / "s.ckpt")
    assert main(TINY + ["-o", str(out), "--device", "cpu", "--sharded", "--checkpoint", ckpt]) == 0
    assert np.asarray(Image.open(out)).shape == (8, 8, 4)
    cfg = RenderConfig(scene="cornell", width=8, height=8, spp=1, mode="rgb", max_depth=2)
    from_cli = ProgressiveRenderer(cfg, checkpoint_path=ckpt, mesh=make_mesh(["cpu"]), device="cpu")
    assert from_cli.resume() and from_cli.spp_done == 1
    fresh = ProgressiveRenderer(cfg, mesh=make_mesh(["cpu"]), device="cpu")
    fresh.run()
    for got, want in zip(from_cli.mean_value(), fresh.mean_value()):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="different RenderConfig"):
        ProgressiveRenderer(cfg, checkpoint_path=ckpt, device="cpu").resume()


def test_sp_beyond_the_devices_exits_nonzero(tmp_path, capsys):
    out = tmp_path / "never.png"
    assert main(TINY + ["-o", str(out), "--device", "cpu", "--sp", "2"]) != 0
    assert "mesh 0x2 != 1 devices" in capsys.readouterr().err
    assert not out.exists()


def test_coordinator_renders_through_gloo(tmp_path, capsys):
    """``--coordinator`` with one process on the CPU joins a gloo group,
    renders through ``render_accumulate_multihost``, writes the image from
    process 0 and leaves the group."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mh.png"
    argv = TINY[:-1] + ["-o", str(out), "--device", "cpu", "--coordinator", f"localhost:{port}",
                        "--num-processes", "1", "--process-id", "0"]
    assert main(argv) == 0
    assert "on 1 processes (cpu)" in capsys.readouterr().out
    assert not dist.is_initialized()
    im = np.asarray(Image.open(out))
    assert im.shape == (8, 8, 4) and im[2:6, 2:6, 3].min() == 255


@pytest.mark.parametrize(
    "flags",
    [
        ["--window", "ansi"],
        ["--debug-checks"],
        ["--intersect-impl", "bvh"],
        ["-s", "cornell-stress", "--stress-boxes", "60", "--stress-spheres", "30", "--intersect-impl", "bvh"],
    ],
    ids=" ".join,
)
def test_progressive_path_flags_write_a_png(tmp_path, capsys, flags):
    """The flags the progressive path, the debug checks and the BVH arm
    brought (each refused as "not ported yet" before): an 8x8 CLI render on
    the CPU that writes a PNG; the ANSI preview draws after each pass."""
    out = tmp_path / "t.png"
    assert main(TINY + flags + ["-o", str(out), "--device", "cpu"]) == 0
    im = np.asarray(Image.open(out))
    assert im.shape == (8, 8, 4) and im[..., :3].max() > 0
    assert im[2:6, 2:6, 3].min() == 255
    if "--window" in flags:
        assert "1 / 1 spp" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags",
    [
        ["-s", "cornell-srgb", "--mode", "meng"],
        ["-s", "cornell-srgb", "--mode", "jakob"],
        ["-s", "plane-srgb", "--mode", "jakob", "--no-els"],
    ],
    ids=" ".join,
)
def test_colour_pipelines_and_plane_srgb_write_a_png(tmp_path, flags):
    """The flags the meng and jakob pipelines and the plane-srgb scene
    brought: an 8x8 CLI render on the CPU that writes a PNG."""
    out = tmp_path / "t.png"
    assert main(TINY + flags + ["-o", str(out), "--device", "cpu"]) == 0
    im = np.asarray(Image.open(out))
    assert im.shape == (8, 8, 4) and im[..., :3].max() > 0
    assert im[2:6, 2:6, 3].min() == 255


def test_cornell_stress_renders_through_the_cull_arm(tmp_path):
    from simple_spectral_torch.render import cull

    out = tmp_path / "stress.png"
    before = cull.LAUNCHES
    argv = TINY + ["-s", "cornell-stress", "--stress-boxes", "40", "--stress-spheres", "20",
                   "--intersect-impl", "cull", "-o", str(out), "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the host's cores
    try:
        assert main(argv) == 0
    finally:
        torch.set_num_threads(threads)
    assert cull.LAUNCHES == before  # CPU tensors run the twin, not the kernel
    im = np.asarray(Image.open(out))
    assert im.shape == (8, 8, 4) and im[2:6, 2:6, 3].min() == 255


def test_default_device_needs_a_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(TINY + ["-o", str(tmp_path / "x.png")]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_runs_without_jax(tmp_path):
    """The port imports and renders, an rgb frame through the progressive
    path with a checkpoint and a jakob plane-srgb frame, with ``jax`` and
    the JAX package made unimportable in a fresh interpreter."""
    out = tmp_path / "nojax.png"
    plane = tmp_path / "nojax-plane.png"
    ckpt = tmp_path / "nojax.ckpt"
    rgb = TINY + ["-o", str(out), "--device", "cpu", "--checkpoint", str(ckpt), "--metrics-json", "-"]
    jakob = TINY + ["-s", "plane-srgb", "--mode", "jakob", "--no-els", "-o", str(plane), "--device", "cpu"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simple_spectral_tpu'] = None\n"
        "from simple_spectral_torch.cli import main\n"
        f"rc = main({rgb!r}) or main({jakob!r})\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(m.startswith('simple_spectral_tpu.') for m in sys.modules)\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert Image.open(out).size == Image.open(plane).size == (8, 8)
    assert ckpt.exists() and json.loads(proc.stdout.strip().splitlines()[-1])["spp"] == 1
