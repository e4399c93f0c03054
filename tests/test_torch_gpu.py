"""The port on a CUDA card: kernel K1 against its plain twin key for key, and
a tiny render through K1 against the same render through the twin on the
CPU.  Imports nothing of JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.)  Every test skips
without a card; the K1 kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import intersect_pallas as k1
from simple_spectral_torch.render.renderer import render_accumulate
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables

pytestmark = pytest.mark.gpu

EPS = 1e-3
CFG = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=2, max_depth=4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scenes(cuda):
    cpu = torch.device("cpu")
    t_cpu, t_gpu = build_color_tables(CFG, device=cpu), build_color_tables(CFG, device=cuda)
    return (build_scene(CFG, t_cpu, device=cpu), t_cpu), (build_scene(CFG, t_gpu, device=cuda), t_gpu)


@pytest.mark.parametrize("n", [1, 7, 130, 2049, 4096])
@pytest.mark.parametrize("ignore", [False, True], ids=["no-ignore", "ignore-prim"])
def test_kernel_matches_twin(cuda, scenes, n, ignore):
    _, (scene, _) = scenes
    rng = np.random.default_rng(n + ignore)
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ign = rng.integers(-1, scene.n_prims, n) if ignore else np.full(n, -1)
    ov = V3(*(torch.from_numpy(o[:, a].copy()).to(cuda) for a in range(3)))
    dv = V3(*(torch.from_numpy(d[:, a].copy()).to(cuda) for a in range(3)))
    ig = torch.from_numpy(ign.astype(np.int32)).to(cuda)
    before = k1.LAUNCHES
    got = k1.intersect_best_key(scene.tri_verts, scene.tri_prim, ov, dv, ig, EPS)
    want = k1.best_key_plain(scene.tri_verts, scene.tri_prim, ov, dv, ig, EPS)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_render_through_kernel_matches_twin_render(cuda, scenes):
    """The same frame through K1 and through the twin on the CPU, within the
    flip bound of tests/test_parallel.py (the card's transcendentals differ
    from the CPU's in the last bits)."""
    (s_cpu, t_cpu), (s_gpu, t_gpu) = scenes
    k1.LAUNCHES = 0
    v_gpu, a_gpu = render_accumulate(CFG, s_gpu, t_gpu, seed=3)
    assert k1.LAUNCHES == (2 * CFG.max_depth - 2) * CFG.spp
    v_cpu, a_cpu = render_accumulate(CFG, s_cpu, t_cpu, seed=3)
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    assert int((~(rel < 1e-3).all(axis=-1)).sum()) <= 4
    assert (rel < 0.5).all()
    np.testing.assert_allclose(v_gpu.mean(axis=(0, 1)), v_cpu.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_gpu, a_cpu)
