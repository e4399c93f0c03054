"""The port's mesh rendering (``simple_spectral_torch/parallel/sharding.py``)
against the JAX package's, on the CPU.

The port's mesh is a list of devices that may repeat: ``["cpu"] * 8`` stands
for the 8 virtual CPU devices that tests/conftest.py gives JAX.  One JAX
compile serves the file: ``_sharded_chunk`` on the 4x2 mesh for cornell,
mallett, 8x8, spp 8, depth 4.  The progressive tests render one pass of all
8 spp over the 64 pixels, so JAX's progressive renderer calls the same
``_sharded_chunk`` with the same static arguments.  Images are held within
the flip bound of tests/test_parallel.py: at most 4 of 64 pixels off by rel
>= 1e-3, each within rel < 0.5, means to 2e-3; alpha, a hit count, exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from simple_spectral_torch import convert
from simple_spectral_torch import parallel as tparallel
from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.parallel import sharding as tsh
from simple_spectral_torch.render import progressive as tprog
from simple_spectral_torch.render.renderer import _render_chunk
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_torch.utils.native_fb import load_native
from simple_spectral_tpu import parallel as jparallel
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.parallel import sharding as jsh
from simple_spectral_tpu.render import progressive as jprog
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

KW = dict(scene="cornell", mode="mallett", width=8, height=8, spp=8, max_depth=4)
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on one
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = RenderConfig(**KW), TorchConfig(**KW)
    jt = build_color_tables(cfg)
    tt = t_build_tables(tcfg, device="cpu")
    return cfg, build_scene(cfg, jt), jt, tcfg, t_build_scene(tcfg, tt, device="cpu"), tt


def _assert_flip_bound(v_got, v_ref):
    rel = np.abs(v_got - v_ref) / (np.abs(v_ref) + 1e-3)
    flipped = int((~(rel < 1e-3).all(axis=-1)).sum())
    assert flipped <= 4, f"{flipped}/64 pixels differ"
    assert (rel < 0.5).all(), f"worst rel dev {rel.max():.3f}"
    np.testing.assert_allclose(v_got.mean(axis=(0, 1)), v_ref.mean(axis=(0, 1)), rtol=2e-3)


def test_parallel_exports_match_jax():
    assert tparallel.__all__ == jparallel.__all__
    assert all(hasattr(tparallel, name) for name in tparallel.__all__)


@pytest.mark.parametrize("kw", [{}, dict(sp=2), dict(dp=2), dict(sp=8), dict(dp=8, sp=1)],
                         ids=["default", "sp2", "dp2", "sp8", "dp8-sp1"])
def test_mesh_factorizations_equal_jax(kw):
    mesh = tsh.make_mesh(CPU8, **kw)
    assert mesh.shape == dict(jsh.make_mesh(**kw).shape)
    assert [len(row) for row in mesh.devices] == [mesh.shape["sp"]] * mesh.shape["dp"]
    assert mesh.owned == [divmod(f, mesh.shape["sp"]) for f in range(8)]


def test_mesh_refuses_a_factorization_of_other_devices():
    with pytest.raises(AssertionError, match="mesh 2x2 != 8 devices"):
        jsh.make_mesh(dp=2, sp=2)
    with pytest.raises(ValueError, match="mesh 2x2 != 8 devices"):
        tsh.make_mesh(CPU8, dp=2, sp=2)
    with pytest.raises(ValueError, match="mesh 0x2 != 1 devices"):
        tsh.make_mesh(["cpu"], sp=2)


@pytest.mark.parametrize("kw", [{}, dict(sp=4)], ids=["8x1", "2x4"])
def test_panel_estimate_is_exact_on_every_mesh(kw):
    """The emissive-panel scene is variance-free in rgb mode (every sample
    sees exactly the emission), so a dp-only and a dp x sp mesh both give
    the emission (tests/test_parallel.py)."""
    from tests.test_render import panel_scene

    cfg = RenderConfig(scene="cornell", mode="rgb", width=8, height=8, spp=8, max_depth=4)
    leaves = _leaves(panel_scene(cfg, build_color_tables(cfg)))
    tcfg = TorchConfig(**dataclasses.asdict(cfg))
    tt = t_build_tables(tcfg, device="cpu")
    value, alpha = tsh.render_accumulate_sharded(tcfg, convert.scene_from_numpy(leaves, device="cpu"), tt,
                                                 tsh.make_mesh(CPU8, **kw), seed=3)
    assert np.allclose(alpha, 1.0)
    assert np.allclose(value, [0.25, 0.5, 0.75], atol=1e-6)


def _leaves(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _leaves(v)
        elif v is None or isinstance(v, (int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def test_sharded_render_matches_jax(setup):
    """cornell mallett on the 4x2 mesh: the same per-shard streams in both
    packages, so the images agree within the flip bound and alpha exactly."""
    cfg, js, jt, tcfg, ts, tt = setup
    vj, aj = jsh.render_accumulate_sharded(cfg, js, jt, jsh.make_mesh(sp=2), seed=5)
    vt, at = tsh.render_accumulate_sharded(tcfg, ts, tt, tsh.make_mesh(CPU8, sp=2), seed=5)
    assert vt.shape == (8, 8, 3) and at.shape == (8, 8)
    _assert_flip_bound(vt, vj)
    np.testing.assert_array_equal(at, aj)


def test_sharded_chunk_is_each_shards_own_render(setup):
    """Shard (di, si) renders spp/sp samples of the di-th pixel slice from
    fold_in(fold_in(key, di), si); the sp partials add in shard order.  The
    port's sharded chunk is that sum of ``_render_chunk`` calls bit for
    bit, with the pixels padded to a multiple of dp."""
    _, _, _, tcfg, ts, tt = setup
    mesh = tsh.make_mesh(["cpu"] * 6, sp=2)
    key = rnd.fold_in(rnd.PRNGKey(11), 4)
    px, n_real = tsh._pad_to(torch.arange(10, 20, dtype=torch.int32), 3)
    assert (px.shape[0], n_real) == (12, 10) and not px[10:].any()
    got_v, got_a = tsh.sharded_sample_sums(ts, tt, tcfg, mesh, key, px, 2)
    for di in range(3):
        parts = [_render_chunk(ts, tt, tcfg, rnd.fold_in(rnd.fold_in(key, di), si), px[4 * di:4 * di + 4], 1)
                 for si in range(2)]
        assert torch.equal(got_v[4 * di:4 * di + 4], parts[0][0] + parts[1][0])
        assert torch.equal(got_a[4 * di:4 * di + 4], parts[0][1] + parts[1][1])
    with pytest.raises(ValueError, match="spp by sp=2"):
        tsh.sharded_sample_sums(ts, tt, tcfg, mesh, key, px, 3)


def _renderers(setup, **kw):
    cfg, js, jt, tcfg, ts, tt = setup
    jr = jprog.ProgressiveRenderer(cfg, js, jt, spp_per_pass=cfg.spp, mesh=jsh.make_mesh(sp=2), **kw)
    tr = tprog.ProgressiveRenderer(tcfg, ts, tt, spp_per_pass=tcfg.spp, mesh=tsh.make_mesh(CPU8, sp=2), **kw)
    return jr, tr


def test_progressive_on_a_mesh_matches_jax(setup):
    """One pass of 8 spp on the 4x2 mesh in both packages: the same mesh
    fingerprint, means within the flip bound, alpha exactly."""
    jr, tr = _renderers(setup, seed=2, native=False)
    assert tprog._cfg_fingerprint(tr.cfg, tr.mesh) == jprog._cfg_fingerprint(jr.cfg, jr.mesh)
    assert '"_mesh": {"dp": 4, "sp": 2}' in tprog._cfg_fingerprint(tr.cfg, tr.mesh)
    jr.run()
    tr.run()
    (vj, aj), (vt, at) = jr.mean_value(), tr.mean_value()
    _assert_flip_bound(vt, vj)
    np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_mesh_checkpoints_cross_packages(setup, tmp_path, native):
    """A checkpoint of a mesh render written by the JAX renderer resumes in
    the port and the reverse, in both accumulators; a renderer without the
    mesh refuses it."""
    if native and load_native() is None:
        pytest.skip("no C++ compiler")
    j_path, t_path = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jr, _ = _renderers(setup, seed=4, checkpoint_path=j_path, native=native)
    jr.run_pass()
    jr.save_checkpoint()
    _, tr = _renderers(setup, seed=4, checkpoint_path=j_path, native=native)
    assert tr.native == native and tr.resume() and tr.spp_done == 8
    for got, want in zip(tr.mean_value(), jr.mean_value()):
        np.testing.assert_array_equal(got, want)
    tr.save_checkpoint(t_path)
    jr2, _ = _renderers(setup, seed=4, checkpoint_path=t_path, native=native)
    assert jr2.resume() and jr2.spp_done == 8
    for got, want in zip(jr2.mean_value(), tr.mean_value()):
        np.testing.assert_array_equal(got, want)
    _, _, _, tcfg, ts, tt = setup
    with pytest.raises(ValueError, match="different RenderConfig"):
        tprog.ProgressiveRenderer(tcfg, ts, tt, seed=4, checkpoint_path=t_path, native=native).resume()


def test_mesh_resume_is_bitwise_and_needs_the_same_mesh(setup, tmp_path):
    """4 spp on the 4x2 mesh in passes of 2: a render interrupted after one
    pass and resumed equals the uninterrupted one bit for bit; an 8x1 mesh
    (other sample streams) refuses the checkpoint; a pass must divide by
    sp."""
    _, _, _, tcfg, ts, tt = setup
    tcfg = tcfg.replace(spp=4)
    ckpt = str(tmp_path / "m.ckpt")

    def renderer(mesh=tsh.make_mesh(CPU8, sp=2), **kw):
        return tprog.ProgressiveRenderer(tcfg, ts, tt, seed=6, spp_per_pass=2, native=False, mesh=mesh, **kw)

    whole = renderer()
    whole.run()
    first = renderer(checkpoint_path=ckpt)
    first.run_pass()
    first.save_checkpoint()
    second = renderer(checkpoint_path=ckpt)
    assert second.resume() and second.spp_done == 2
    second.run()
    for got, want in zip(second.mean_value(), whole.mean_value()):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="different RenderConfig"):
        renderer(mesh=tsh.make_mesh(CPU8), checkpoint_path=ckpt).resume()
    with pytest.raises(ValueError, match="sp mesh axis"):
        renderer(mesh=tsh.make_mesh(CPU8, sp=4))
    with pytest.raises(ValueError, match="sp mesh axis"):
        renderer().run_pass(1)


def test_jax_key_streams_reach_the_shards():
    """The shard key is the JAX package's fold_in(fold_in(key, di), si)."""
    key = rnd.fold_in(rnd.PRNGKey(5), 0)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 0)
    for di, si in ((0, 0), (3, 1), (7, 0)):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.fold_in(jkey, di), si)))
        np.testing.assert_array_equal(rnd.fold_in(rnd.fold_in(key, di), si).numpy(), want.astype(np.int64))
