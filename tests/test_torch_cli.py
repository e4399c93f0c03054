"""The port's command line: its flag surface against the JAX package's, a
tiny render on the CPU, the flags it refuses, and a run in a process where
``jax`` and ``simple_spectral_tpu`` cannot be imported."""

import os
import subprocess
import sys

import numpy as np
import pytest
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


@pytest.mark.parametrize(
    "flags, item",
    [
        (["--mode", "meng"], 11),
        (["--mode", "jakob"], 10),
        (["--sharded"], 14),
        (["--sp", "2"], 14),
        (["--coordinator", "localhost:1234"], 14),
        (["--window"], 15),
        (["--checkpoint", "ck.npz"], 15),
        (["--intersect-impl", "bvh"], 13),
        (["--intersect-impl", "cull"], 13),
        (["-s", "plane-srgb"], 10),
    ],
    ids=lambda v: " ".join(v) if isinstance(v, list) else str(v),
)
def test_unported_flags_exit_nonzero(tmp_path, capsys, flags, item):
    out = tmp_path / "never.png"
    assert main(TINY + ["-o", str(out), "--device", "cpu"] + flags) != 0
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item})" in err
    assert not out.exists()


def test_default_device_needs_a_card(tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(TINY + ["-o", str(tmp_path / "x.png")]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_runs_without_jax(tmp_path):
    """The port imports and renders with ``jax`` and the JAX package made
    unimportable in a fresh interpreter."""
    out = tmp_path / "nojax.png"
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['simple_spectral_tpu'] = None\n"
        "from simple_spectral_torch.cli import main\n"
        f"rc = main({TINY + ['-o', str(out), '--device', 'cpu']!r})\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(m.startswith('simple_spectral_tpu.') for m in sys.modules)\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert Image.open(out).size == (8, 8)
