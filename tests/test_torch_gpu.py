"""The port on a CUDA card: kernels K1 (both key widths), K2, S1,
gather_u32, T1 (threefry, in its three epilogues, with one launch per
draw of a train step) and M1 (Meng's albedo, once a bounce of a meng train
step) against their plain twins, tiny renders through K1
and K2 against the same renders through the twins on the CPU (bench.py's
configurations 3 and 4, meng and jakob, among them), the train step on
the card against the CPU, the progressive renderer's bitwise resume, the
BVH walk against K1, the sharded train step on a 4x2 mesh of the one card
against its emulation, a world of one process through NCCL, and, where a
machine has more than one card, one process per card through NCCL.
Imports nothing of JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.)  Every test skips
without a card; the CUDA kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import cull as k2
from simple_spectral_torch.render import intersect_pallas as k1
from simple_spectral_torch import random as rnd
from simple_spectral_torch.render import bvh
from simple_spectral_torch.render.intersect import intersect_rays_dispatch
from simple_spectral_torch.render.progressive import ProgressiveRenderer
from simple_spectral_torch.render.renderer import render_accumulate
from simple_spectral_torch.render.trainstep import forward_backward_step
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.scene.library import build_scene
from simple_spectral_torch.spectra import upsample_meng as um
from simple_spectral_torch.spectra.colorimetry import build_color_tables
from simple_spectral_torch.tools import bench_gather as tg
from simple_spectral_torch.tools import bench_megakernel as s1

pytestmark = pytest.mark.gpu

EPS = 1e-3
CFG = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=2, max_depth=4)
STRESS = RenderConfig(scene="cornell-stress", mode="rgb", width=8, height=8, spp=2, max_depth=4, stress_boxes=40,
                      stress_spheres=20, stress_sphere_lights=2, intersect_impl="cull")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scenes(cuda):
    cpu = torch.device("cpu")
    t_cpu, t_gpu = build_color_tables(CFG, device=cpu), build_color_tables(CFG, device=cuda)
    return (build_scene(CFG, t_cpu, device=cpu), t_cpu), (build_scene(CFG, t_gpu, device=cuda), t_gpu)


def _random_rays(device, lo, hi, n, n_prims, ignore, seed):
    """Seeded rays with origins inside [lo, hi] and unit directions, and
    the ignored primitive (random ids, or -1 without ``ignore``)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ign = rng.integers(-1, n_prims, n) if ignore else np.full(n, -1)
    ov = V3(*(torch.from_numpy(o[:, a].copy()).to(device) for a in range(3)))
    dv = V3(*(torch.from_numpy(d[:, a].copy()).to(device) for a in range(3)))
    return ov, dv, torch.from_numpy(ign.astype(np.int32)).to(device)


def _k1_matches_twin(tri_verts, tri_prim, ov, dv, ig, exact):
    before = k1.LAUNCHES
    got = k1.intersect_best_key(tri_verts, tri_prim, ov, dv, ig, EPS, exact)
    want = k1.best_key_plain(tri_verts, tri_prim, ov, dv, ig, EPS, exact)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert got.dtype == (torch.int64 if exact else torch.int32)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("n", [1, 7, 130, 2049, 4096])
@pytest.mark.parametrize("ignore", [False, True], ids=["no-ignore", "ignore-prim"])
@pytest.mark.parametrize("exact", [False, True], ids=["quantized", "exact"])
def test_kernel_matches_twin(cuda, scenes, n, ignore, exact):
    _, (scene, _) = scenes
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    ov, dv, ig = _random_rays(cuda, verts.min(axis=0), verts.max(axis=0), n, scene.n_prims, ignore, n + ignore)
    _k1_matches_twin(scene.tri_verts, scene.tri_prim, ov, dv, ig, exact)


# more rays than one grid sized to residency takes in one pass (at most
# 1056 CTAs of 128 threads with two rays each on an H100: 270,336 rays), so
# that CTAs stride over several groups of rays
@pytest.mark.parametrize("n", [262145, 600000])
@pytest.mark.parametrize("exact", [False, True], ids=["quantized", "exact"])
def test_kernel_matches_twin_over_one_resident_grid(cuda, scenes, n, exact):
    _, (scene, _) = scenes
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    ov, dv, ig = _random_rays(cuda, verts.min(axis=0), verts.max(axis=0), n, scene.n_prims, True, n)
    got = _k1_matches_twin(scene.tri_verts, scene.tri_prim, ov, dv, ig, exact)
    assert int(k1.key_parts(got, scene.n_tris, exact)[0].sum()) > n // 2


# triangle counts over one 128-triangle tile, with and without a remainder
@pytest.mark.parametrize("t", [129, 256, 300, 1000])
@pytest.mark.parametrize("exact", [False, True], ids=["quantized", "exact"])
def test_kernel_matches_twin_over_several_tiles(cuda, t, exact):
    rng = np.random.default_rng(t)
    centre = rng.uniform(0.0, 1.0, size=(t, 1, 3))
    tri = (centre + rng.uniform(-0.15, 0.15, size=(t, 3, 3))).astype(np.float32)
    prim = rng.integers(0, t // 2, t).astype(np.int32)  # ids shared by two triangles on average
    tv, tp = torch.from_numpy(tri).to(cuda), torch.from_numpy(prim).to(cuda)
    ov, dv, ig = _random_rays(cuda, 0.0, 1.0, 3001, t // 2, True, t)
    got = _k1_matches_twin(tv, tp, ov, dv, ig, exact)
    assert int(k1.key_parts(got, t, exact)[0].sum()) > 3001 // 4  # 827 of 3001 at T = 129 on the twin


def test_kernel_matches_twin_on_the_dense_route_at_stress_scale(cuda):
    """cornell-stress at 1000 boxes below the cull threshold: K1 over its
    10,038 triangles (79 tiles, the last one partial) on random rays."""
    cfg = RenderConfig(scene="cornell-stress", mode="rgb", width=8, height=8, stress_boxes=1000,
                       bvh_threshold=1 << 30)
    scene = build_scene(cfg, build_color_tables(cfg, device=cuda), device=cuda)
    assert scene.n_tris == 10038
    ov, dv, ig = _random_rays(cuda, 20.0, 530.0, 2049, scene.n_prims, True, 5)
    for exact in (False, True):
        _k1_matches_twin(scene.tri_verts, scene.tri_prim, ov, dv, ig, exact)


@pytest.mark.parametrize("fault", ["dtype", "device", "length"])
@pytest.mark.parametrize("component", range(6))
def test_six_component_interface_refuses_a_wrong_component(cuda, scenes, fault, component):
    _, (scene, _) = scenes
    ov, dv, ig = _random_rays(cuda, 0.0, 1.0, 64, scene.n_prims, False, 0)
    comps = [*ov, *dv]
    c = comps[component]
    comps[component] = {"dtype": c.double(), "device": c.cpu(), "length": torch.cat([c, c[:1]])}[fault]
    before = k1.LAUNCHES
    with pytest.raises(ValueError, match="d\\.[xyz]|o\\.[xyz]|CUDA"):
        k1.best_key_cuda(V3(*comps[:3]), V3(*comps[3:]), ig, scene.tri_verts.reshape(-1, 9).contiguous(),
                         scene.tri_prim, EPS, exact=True)
    assert k1.LAUNCHES == before


def test_six_component_interface_takes_strided_components(cuda, scenes):
    """A component that is a strided view is made contiguous on its own."""
    _, (scene, _) = scenes
    verts = scene.tri_verts.reshape(-1, 3).cpu().numpy()
    ov, dv, ig = _random_rays(cuda, verts.min(axis=0), verts.max(axis=0), 4096, scene.n_prims, True, 9)
    packed = torch.stack([*ov, *dv], dim=1)  # [N, 6]: every column a strided view
    o_s, d_s = V3(*(packed[:, a] for a in range(3))), V3(*(packed[:, 3 + a] for a in range(3)))
    assert not o_s.x.is_contiguous()
    got = k1.best_key_cuda(o_s, d_s, ig, scene.tri_verts.reshape(-1, 9).contiguous(), scene.tri_prim, EPS, True)
    want = k1.best_key_plain(scene.tri_verts, scene.tri_prim, ov, dv, ig, EPS, True)
    torch.cuda.synchronize()
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


@pytest.fixture(scope="module")
def stress_scenes(cuda):
    cpu = torch.device("cpu")
    t_cpu, t_gpu = build_color_tables(STRESS, device=cpu), build_color_tables(STRESS, device=cuda)
    return (build_scene(STRESS, t_cpu, device=cpu), t_cpu), (build_scene(STRESS, t_gpu, device=cuda), t_gpu)


# warps of K2 partly real and partly padding (31, 33, 1023, 1025, 5000),
# one lane, and a full sweep
@pytest.mark.parametrize("n", [1, 31, 33, 1023, 1025, 5000, 262144])
@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("ignore", [False, True], ids=["no-ignore", "ignore-prim"])
def test_k2_matches_twin(cuda, stress_scenes, n, sort, ignore):
    _, (scene, _) = stress_scenes
    rng = np.random.default_rng(n + 2 * sort + ignore)
    o = rng.uniform(20.0, 530.0, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ign = rng.integers(-1, scene.n_prims, n) if ignore else np.full(n, -1)
    ov = V3(*(torch.from_numpy(o[:, a].copy()).to(cuda) for a in range(3)))
    dv = V3(*(torch.from_numpy(d[:, a].copy()).to(cuda) for a in range(3)))
    ig = torch.from_numpy(ign.astype(np.int32)).to(cuda)
    if sort:
        order = k2.morton_order(scene.cull_tiles, ov, dv)
        ov, dv, ig = V3(*(c[order] for c in ov)), V3(*(c[order] for c in dv)), ig[order]
    rays = k2.cull_rays(ov, dv, ig)
    counts, lists, entries = k2.cull_lists(scene.cull_tiles, rays, EPS)
    before = k2.LAUNCHES
    got = k2.cull_best(scene.cull_tiles, counts, lists, entries, rays, n, EPS)
    want = k2.cull_best_plain(scene.cull_tiles, counts, lists, rays, EPS)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    assert torch.equal(got[:, :n], want[:, :n])
    assert bool((got[0, n:] == k2.INF_BITS).all()) and bool((got[1, n:] == 0).all())
    # the kernel's own work is that of the twin's walk with a warp's exit vote
    visits = torch.zeros((3, counts.shape[0]), dtype=torch.int32, device=cuda)
    k2.cull_best_cuda(scene.cull_tiles, counts, lists, entries, rays, n, EPS, visits=visits)
    work = k2.cull_work(scene.cull_tiles, counts, lists, entries, rays, EPS, n_valid=n, group=k2.WARP)
    assert int(visits[0].sum()) * k2.WARP == int(work["slab"].sum())
    assert (int(visits[1].sum()), int(visits[2].sum())) == (int(work["tri"].sum()), int(work["sphere"].sum()))


def test_render_through_k2_matches_twin_render(cuda, stress_scenes):
    """A stress frame with two sphere lights through K2 and through the twin
    on the CPU, within the flip bound of tests/test_parallel.py."""
    (s_cpu, t_cpu), (s_gpu, t_gpu) = stress_scenes
    k1.LAUNCHES = k2.LAUNCHES = 0
    v_gpu, a_gpu = render_accumulate(STRESS, s_gpu, t_gpu, seed=3)
    assert k2.LAUNCHES == (2 * STRESS.max_depth - 2) * STRESS.spp and k1.LAUNCHES == 0
    v_cpu, a_cpu = render_accumulate(STRESS, s_cpu, t_cpu, seed=3)
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    assert int((~(rel < 1e-3).all(axis=-1)).sum()) <= 4
    assert (rel < 0.5).all()
    np.testing.assert_allclose(v_gpu.mean(axis=(0, 1)), v_cpu.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_gpu, a_cpu)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """forward_backward_step at 8x8, 2 spp, depth 3 on the card and on the
    CPU, within tests/test_torch_trainstep.py's bound for two
    implementations (loss rtol 1e-4, gradients scaled by their max atol
    1e-2)."""
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=2, max_depth=3)
    target = np.random.default_rng(3).uniform(0.0, 2.0, (64, 3)).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        tables = build_color_tables(cfg, device=dev)
        px = torch.arange(64, dtype=torch.int32, device=dev)
        k1.LAUNCHES = 0
        loss, grads = forward_backward_step(build_scene(cfg, tables, device=dev), tables, cfg, rnd.PRNGKey(3), px,
                                            torch.from_numpy(target).to(dev), cfg.spp)
        out.append((float(loss), {f: g.cpu().numpy() for f, g in grads.items()}, k1.LAUNCHES))
    (l_gpu, g_gpu, launches), (l_cpu, g_cpu, _) = out
    assert launches == (2 * cfg.max_depth - 2) * cfg.spp
    assert abs(l_gpu / l_cpu - 1.0) < 1e-4
    for f in g_cpu:
        scale = max(np.abs(g_cpu[f]).max(), 1e-8)
        np.testing.assert_allclose(g_gpu[f] / scale, g_cpu[f] / scale, atol=1e-2, err_msg=f)


# bench.py's BASELINE configurations 3 and 4 at 16x16, 2 spp, in both texel
# formats
COLOUR = {
    "cfg3-meng": dict(scene="cornell-srgb", mode="meng", observer=2006, els=True),
    "cfg4-jakob": dict(scene="plane-srgb", mode="jakob", observer=1931, els=False),
}


@pytest.mark.parametrize("fmt", ["u32", "rows"])
@pytest.mark.parametrize("name", list(COLOUR))
def test_colour_pipeline_render_on_the_card_matches_the_cpu(cuda, name, fmt):
    """The meng and jakob renders through K1 on the card against the same
    renders on the CPU, within the flip bound of tests/test_parallel.py
    (at most 16 of 256 pixels apart by rel >= 1e-3, none by 0.5, means
    within 2e-3, alpha equal)."""
    cfg = RenderConfig(**COLOUR[name], width=16, height=16, spp=2, max_depth=10, texel_format=fmt)
    out = []
    for dev in (cuda, torch.device("cpu")):
        tables = build_color_tables(cfg, device=dev)
        scene = build_scene(cfg, tables, device=dev)
        k1.LAUNCHES = k2.LAUNCHES = 0
        out.append(render_accumulate(cfg, scene, tables, seed=3) + (k1.LAUNCHES, k2.LAUNCHES))
    (v_gpu, a_gpu, launches, k2_launches), (v_cpu, a_cpu, _, _) = out
    per_sample = 2 * cfg.max_depth - 2 if cfg.els else cfg.max_depth
    assert launches == per_sample * cfg.spp and k2_launches == 0
    assert np.isfinite(v_gpu).all()
    rel = np.abs(v_gpu - v_cpu) / (np.abs(v_cpu) + 1e-3)
    assert int((~(rel < 1e-3).all(axis=-1)).sum()) <= 16
    assert (rel < 0.5).all()
    np.testing.assert_allclose(v_gpu.mean(axis=(0, 1)), v_cpu.mean(axis=(0, 1)), rtol=2e-3)
    np.testing.assert_array_equal(a_gpu, a_cpu)


# 262145: more lanes than one grid sized to residency takes in one pass
@pytest.mark.parametrize("n", [1, 255, 4096, 262144, 262145])
def test_fused_bounce_matches_twin(cuda, n):
    """S1 against its twin: distance and both primitive ids bit for bit, wi
    and n.wi within s1.WI_TOL."""
    s1.LAUNCHES = 0
    rows, light, rays, u, got = s1.run(cuda, n, seed=n)
    want = s1.bounce_plain(rows, light, rays, u)
    torch.cuda.synchronize()
    assert s1.LAUNCHES == 1
    diff = s1.compare(got, want)
    assert diff["dist_prim_bits_differ"] == 0
    assert diff["wi_ndl_max_abs_err"] <= s1.WI_TOL
    if n >= 4096:
        assert int(torch.isfinite(got[0]).sum()) > 0.9 * n


@pytest.mark.parametrize("variant", range(6))
def test_gather_matches_twin_and_torch(cuda, variant):
    table, idx = tg.texel_indices(cuda, size=32, max_depth=4)
    label, tab, ind, rows, cols, axis, mask = tg.variants(table, idx, lanes=4099)[variant]
    tg.LAUNCHES = 0
    got = tg.gather_u32(tab, ind, rows, cols, axis, mask)
    want = tg.gather_u32_plain(tab, ind, rows, cols, axis, mask)
    lib = tg.library_call(tab, ind, rows, cols, axis)()
    torch.cuda.synchronize()
    assert tg.LAUNCHES == 1, label
    assert torch.equal(got, want), label
    assert torch.equal(lib.reshape(rows, cols), want), label


@pytest.mark.parametrize("offset, rows, cols, axis, mask", [
    (0, 4096, 1, 0, 1023),  # flat take, four words per thread
    (1, 4096, 1, 0, 1023),  # flat take from an unaligned index view: one word per thread
    (0, 4097, 1, 0, 1023),  # a count that is not a multiple of four
    (0, 64, 1, 1, 0),  # axis 1 of a one-column table is no flat take
    (0, 64, 6, 0, 127),  # rows of six words
    (0, 64, 8, 1, 7),  # rows of eight words, four words per thread
])
def test_gather_paths_of_the_kernel(cuda, offset, rows, cols, axis, mask):
    """Each launch shape of gather_u32 (the four-word and the one-word
    threads, the flat case and both axes) against its twin."""
    gen = torch.Generator(device=cuda).manual_seed(rows + cols + offset)
    tab = torch.randint(0, 1 << 24, (1024,), generator=gen, device=cuda, dtype=torch.int32)
    ind = torch.randint(0, 1 << 20, (rows * cols + offset,), generator=gen, device=cuda, dtype=torch.int32)[offset:]
    got = tg.gather_u32(tab, ind, rows, cols, axis, mask)
    assert torch.equal(got, tg.gather_u32_plain(tab, ind, rows, cols, axis, mask))


@pytest.mark.parametrize("offset, rows, cols, axis, mask", [
    (0, 12293, 1, 0, 1023),  # flat, aligned: a last tile and three words past the 16-byte loads
    (3, 70001, 1, 0, 1023),  # flat from an unaligned view, several tiles
    (0, 515, 8, 0, 127),  # axis 0, aligned, a count that is no multiple of a tile
    (2, 515, 8, 0, 127),  # axis 0 from an unaligned view
    (0, 1001, 12, 1, 7),  # axis 1, aligned, rows across tiles
    (1, 333, 100, 1, 63),  # axis 1, unaligned, rows of 100 words
    (0, 3, 5000, 1, 4095),  # axis 1, rows wider than a tile, four words per index load
    (1, 2, 4097, 1, 4095),  # axis 1, rows wider than a tile, one word per index load
])
def test_gather_ragged_counts_and_offsets(cuda, offset, rows, cols, axis, mask):
    """gather_u32 where the index count is no multiple of a thread's 8
    words or of a block's tile, from unaligned views, on each axis."""
    gen = torch.Generator(device=cuda).manual_seed(rows * cols + offset)
    words = max(1024, rows * cols)
    tab = torch.randint(0, 1 << 24, (words,), generator=gen, device=cuda, dtype=torch.int32)
    ind = torch.randint(0, 1 << 20, (rows * cols + offset,), generator=gen, device=cuda, dtype=torch.int32)[offset:]
    got = tg.gather_u32(tab, ind, rows, cols, axis, mask)
    want = tg.gather_u32_plain(tab, ind, rows, cols, axis, mask)
    lib = tg.library_call(tab, ind & mask, rows, cols, axis)()  # the library call reads no mask
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(lib.reshape(rows, cols), want)


def test_progressive_resume_is_bitwise_on_the_card(cuda, scenes, tmp_path):
    """The progressive renderer through K1: a native checkpoint after one
    pass, resumed by a fresh renderer, and the numpy accumulator both give
    the uninterrupted render's mean bit for bit."""
    _, (scene, tables) = scenes
    cfg = CFG.replace(spp=4)

    def renderer(**kw):
        return ProgressiveRenderer(cfg, scene, tables, seed=7, spp_per_pass=2, **kw)

    k1.LAUNCHES = 0
    whole = renderer(native=True)
    whole.run()
    assert k1.LAUNCHES == (2 * cfg.max_depth - 2) * cfg.spp
    ckpt = str(tmp_path / "card.ckpt")
    first = renderer(native=True, checkpoint_path=ckpt)
    first.run_pass()
    first.save_checkpoint()
    resumed = renderer(native=True, checkpoint_path=ckpt)
    assert resumed.resume() and resumed.spp_done == 2
    resumed.run()
    numpy_acc = renderer(native=False)
    numpy_acc.run()
    for other in (resumed, numpy_acc):
        for got, want in zip(other.mean_value(), whole.mean_value()):
            assert np.array_equal(got, want)


def test_bvh_walk_matches_k1_on_the_card(cuda, stress_scenes):
    """The BVH walk on the card against the exact dense route (K1's exact
    key and the sphere sweep): equal hits and distances bit for bit, other
    winners only at exact ties."""
    _, (scene, _) = stress_scenes
    o, d, ign = _random_rays(cuda, 20.0, 530.0, 4096, scene.n_prims, True, 5)
    got = bvh.intersect_rays_bvh(scene, o, d, ign, EPS)
    want = intersect_rays_dispatch(scene, o, d, ign, EPS, impl="xla")
    assert torch.equal(got.hit, want.hit) and torch.equal(got.dist, want.dist)
    assert int(((got.prim != want.prim) | (got.tri != want.tri)).sum()) <= 2


def test_sharded_step_on_a_virtual_mesh_of_the_card(cuda):
    """The dry run on a 4x2 mesh of eight shards on the one card: the
    sharded loss and gradients equal the single-device emulation within the
    dry run's bound, through K1."""
    from simple_spectral_torch.parallel import dryrun

    k1.LAUNCHES = 0
    out = dryrun.dryrun_multichip(8, device="cuda")
    assert out["mesh"] == {"dp": 4, "sp": 2} and out["worst_grad_dev"] <= dryrun.GRAD_ATOL
    assert k1.LAUNCHES > 0


def test_multihost_render_through_nccl_in_a_world_of_one(cuda, scenes):
    """A world of one process on NCCL: the multihost render gathers its
    chunks through NCCL and equals the sharded render on the card bit for
    bit."""
    import socket

    import torch.distributed as dist

    from simple_spectral_torch.parallel.multihost import global_mesh, init_distributed, render_accumulate_multihost
    from simple_spectral_torch.parallel.sharding import make_mesh, render_accumulate_sharded

    _, (scene, tables) = scenes
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"localhost:{port}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl" and global_mesh().distributed
        got = render_accumulate_multihost(CFG, scene, tables, seed=4)
    finally:
        dist.destroy_process_group()
    want = render_accumulate_sharded(CFG, scene, tables, make_mesh(), seed=4)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_multihost_across_cards(cuda, tmp_path, capsys):
    """One process per card through NCCL, in tests/test_torch_multihost.py's
    two layouts (each dp row inside a process, the dp gather between the
    cards; one card per process with the sp sum between them): every rank's
    image equals the single-process render of the same mesh on one card bit
    for bit, its loss and gradients the emulation within the dry run's
    bound.  Needs two cards or more: NCCL refuses two ranks on one card."""
    from test_torch_multihost import check_world, run_world  # pytest puts tests/ on the path

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more: NCCL refuses two ranks on one card")
    results = run_world(n, "cuda", tmp_path)
    check_world(results, "cuda")
    with capsys.disabled():
        print(f"\n{n} ranks through NCCL: one 2^20-lane chunk's gather between the cards "
              f"{[float(r['gather_ms']) for r in results]} ms (host clock, median of 10 per rank)")


# kernel T1 (csrc/threefry.cu) against its int64 twins in random.py: keys
# with a zero word (PRNGKey(0)), a seed above 2^31, and both words hashed
T1_KEYS = {"prngkey0": lambda: rnd.PRNGKey(0), "seed2^31+5": lambda: rnd.PRNGKey(2**31 + 5),
           "folded": lambda: rnd.fold_in(rnd.PRNGKey(1), 7)}
T1_SIZES = [0, 1, 3, 4097, 262144, 2097152]


def _t1_draw(kind, key, shape, dev, bounds=(0, 5)):
    """(kernel draw, twin draw on the same device, T1 launches of the
    kernel's draw)."""
    before = rnd.LAUNCHES
    if kind == "bits":
        got, want = rnd.random_bits(key, shape, dev), rnd.random_bits_plain(key, shape, dev)
    elif kind == "uniform":
        got, want = rnd.uniform(key, shape, dev), rnd.uniform_plain(key, shape, dev)
    else:
        got, want = rnd.randint(key, shape, *bounds, dev), rnd.randint_plain(key, shape, *bounds, dev)
    launches = rnd.LAUNCHES - before
    torch.cuda.synchronize()
    return got, want, launches


def _same_words(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", T1_SIZES)
@pytest.mark.parametrize("key", list(T1_KEYS))
@pytest.mark.parametrize("kind", ["bits", "uniform", "randint"])
def test_threefry_kernel_matches_twin(cuda, kind, key, n):
    got, want, launches = _t1_draw(kind, T1_KEYS[key](), (n,), cuda)
    assert launches == (1 if n else 0)
    _same_words(got, want)
    if kind == "bits" and n:
        assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.mark.parametrize("n", [3, 4097, 262144])
@pytest.mark.parametrize("minval", [0, -1000], ids=["min0", "min-1000"])
@pytest.mark.parametrize("width", [1, 2, 3, 5, 2**31 - 1])
@pytest.mark.parametrize("key", list(T1_KEYS))
def test_threefry_randint_widths_match_twin(cuda, key, width, minval, n):
    got, want, launches = _t1_draw("randint", T1_KEYS[key](), (n,), cuda, (minval, minval + width))
    assert launches == 1
    _same_words(got, want)
    assert int(got.min()) >= minval and int(got.max()) < minval + width


@pytest.mark.parametrize("shape", [(), (3, 5, 7), (4, 65537)], ids=str)
@pytest.mark.parametrize("kind", ["bits", "uniform", "randint"])
def test_threefry_kernel_shapes(cuda, kind, shape):
    got, want, launches = _t1_draw(kind, rnd.PRNGKey(11), shape, cuda, (-2**31, 2**31 - 1))
    assert launches == 1
    _same_words(got, want)


def test_threefry_wrapper_refuses_cpu_and_2_to_the_32(cuda):
    with pytest.raises(ValueError, match="CUDA device"):
        rnd.draw_cuda(rnd.UNIFORM, (0, 1), (4,), torch.device("cpu"))
    before = torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="fewer than 2"):
        rnd.draw_cuda(rnd.BITS, (0, 1), (2**16, 2**16), cuda)
    assert torch.cuda.memory_allocated() == before


def test_every_draw_of_a_train_step_on_the_card_is_one_launch(cuda, monkeypatch):
    """forward_backward_step at 8x8, 2 spp on the card: T1 launches once per
    uniform, random_bits and randint call, and the loss equals the step
    with every draw made by the twins."""
    cfg = RenderConfig(scene="cornell-srgb", mode="mallett", width=8, height=8, spp=2, max_depth=4)
    tables = build_color_tables(cfg, device=cuda)
    scene = build_scene(cfg, tables, device=cuda)
    px = torch.arange(64, dtype=torch.int32, device=cuda)
    target = torch.full((64, 3), 0.5, device=cuda)
    calls = []

    def counted(fn):
        def draw(*args, **kw):
            calls.append(fn.__name__)
            return fn(*args, **kw)
        return draw

    for name in ("uniform", "random_bits", "randint"):
        monkeypatch.setattr(rnd, name, counted(getattr(rnd, name)))
    before = rnd.LAUNCHES
    loss, grads = forward_backward_step(scene, tables, cfg, rnd.PRNGKey(5), px, target, cfg.spp)
    torch.cuda.synchronize()
    assert calls and rnd.LAUNCHES - before == len(calls)
    for name, plain in (("uniform", rnd.uniform_plain), ("random_bits", rnd.random_bits_plain),
                        ("randint", rnd.randint_plain)):
        monkeypatch.setattr(rnd, name, plain)
    loss_twin, grads_twin = forward_backward_step(scene, tables, cfg, rnd.PRNGKey(5), px, target, cfg.spp)
    assert rnd.LAUNCHES - before == len(calls)
    assert float(loss) == float(loss_twin)
    for f in grads:
        assert torch.equal(grads[f], grads_twin[f]), f


# kernel M1 (csrc/meng_albedo.cu) against its twin on the CPU
# (upsample_meng.meng_albedo_hero_plain): seeded sRGB words in the grid's
# inner cells, its boundary (fan) cells and off it, with black, white and the
# saturated primaries and their mixes first, under both observers at 3 and 4
# hero wavelengths, in both texel formats
M1_SIZES = [1, 2097152]
M1_HEROES = {"1931-4wl": (1931, 4), "2006-4wl": (2006, 4), "1931-3wl": (1931, 3), "2006-3wl": (2006, 3)}
M1_EXTREMES = [0x000000, 0xFFFFFF, 0xFF0000, 0x00FF00, 0x0000FF, 0xFFFF00, 0xFF00FF, 0x00FFFF]


@pytest.fixture(scope="module")
def meng_tables(cuda):
    cfg = RenderConfig(mode="meng")
    return build_color_tables(cfg, device=torch.device("cpu")).meng, build_color_tables(cfg, device=cuda).meng


def _m1_texels(meng, fmt, n, lam_lo, step, seed):
    """(texels, lam0) on the CPU: ``n`` seeded words (the extremes first
    where n > 1) or the rows the walk makes of them, and lam0 uniform over
    the first hero band."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 24, n).astype(np.int32)
    if n > 1:
        words[:len(M1_EXTREMES)] = M1_EXTREMES
    words = torch.from_numpy(words)
    lam0 = torch.from_numpy((lam_lo + rng.uniform(0, 1, n) * step).astype(np.float32))
    if fmt == "u32":
        return words, lam0
    lut = um.srgb_decode_table()
    pidx, w = um.meng_cell_weights_soa(meng, *um.lrgb_to_xyz_meng(
        *(lut[((words >> s) & 0xFF).to(torch.int64)] for s in (16, 8, 0))))
    return torch.cat([pidx.T.to(torch.float32), w.T], dim=1).contiguous(), lam0


def _m1_cells(meng, words):
    """(inner, boundary, off-grid) lane counts of the words' walk."""
    lut = um.srgb_decode_table()
    x, y, z = um.lrgb_to_xyz_meng(*(lut[((words >> s) & 0xFF).to(torch.int64)] for s in (16, 8, 0)))
    _, _, _, _, cell, valid, _ = um._uv_position(meng, x, y, z)
    inside, num = um._cell_values(meng, cell)[:2]
    on = valid & (num > 0)
    return int((on & (inside > 0)).sum()), int((on & (inside == 0)).sum()), int((~on).sum())


@pytest.mark.parametrize("n", M1_SIZES)
@pytest.mark.parametrize("fmt", ["u32", "rows"])
@pytest.mark.parametrize("hero", list(M1_HEROES))
def test_meng_kernel_matches_twin(cuda, meng_tables, hero, fmt, n):
    cpu_m, gpu_m = meng_tables
    observer, n_wl = M1_HEROES[hero]
    cfg = RenderConfig(mode="meng", observer=observer, n_wavelengths=n_wl)
    texels, lam0 = _m1_texels(cpu_m, fmt, n, cfg.lambda_min, cfg.lambda_step, seed=n + 10 * n_wl + observer)
    before = um.LAUNCHES
    got = um.meng_albedo_hero(gpu_m, fmt, texels.to(cuda), lam0.to(cuda), n_wl, cfg.lambda_step)
    torch.cuda.synchronize()
    assert um.LAUNCHES == before + 1
    want = um.meng_albedo_hero(cpu_m, fmt, texels, lam0, n_wl, cfg.lambda_step)
    assert got.shape == want.shape == (n_wl, n) and got.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    if n > 1 and fmt == "u32":
        inner, fan, off = _m1_cells(cpu_m, texels)
        assert inner > 0 and fan > 0 and off > 0, (inner, fan, off)


@pytest.mark.parametrize("mode", ["meng", "mallett"])
def test_meng_kernel_launches_once_a_bounce_of_a_train_step(cuda, mode):
    """forward_backward_step at 8x8, 1 spp, depth 10 on the card: M1 launches
    max_depth - 1 times in a meng step, never in a mallett step."""
    cfg = RenderConfig(scene="cornell-srgb", mode=mode, width=8, height=8, spp=1, max_depth=10)
    tables = build_color_tables(cfg, device=cuda)
    scene = build_scene(cfg, tables, device=cuda)
    px = torch.arange(64, dtype=torch.int32, device=cuda)
    target = torch.full((64, 3), 0.5, device=cuda)
    before = um.LAUNCHES
    loss, _ = forward_backward_step(scene, tables, cfg, rnd.PRNGKey(7), px, target, cfg.spp)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert um.LAUNCHES - before == (cfg.max_depth - 1 if mode == "meng" else 0) == (9 if mode == "meng" else 0)


def test_meng_wrapper_refuses_wrong_inputs(cuda, meng_tables):
    cpu_m, gpu_m = meng_tables
    lam0 = torch.full((8,), 500.0, device=cuda)
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    rows = torch.zeros((8, 12), device=cuda)
    before = um.LAUNCHES
    cases = [
        ("texels on", (gpu_m, "u32", words.cpu(), lam0)),  # device
        ("meng table", (cpu_m, "u32", words, lam0)),
        ("CUDA", (cpu_m, "u32", words.cpu(), lam0.cpu())),
        ("lam0", (gpu_m, "u32", words, lam0.double())),  # dtype
        ("u32 texels", (gpu_m, "u32", words.long(), lam0)),
        ("rows texels", (gpu_m, "rows", rows.half(), lam0)),
        ("rows texels", (gpu_m, "rows", rows[:, :11], lam0)),  # shape
        ("u32 texels", (gpu_m, "u32", words[:7], lam0)),
        ("lam0", (gpu_m, "u32", words, lam0[None])),
        ("lam0", (gpu_m, "u32", words, torch.full((16,), 500.0, device=cuda)[::2])),  # contiguity
        ("rows texels", (gpu_m, "rows", torch.zeros((12, 8), device=cuda).T, lam0)),
    ]
    for match, args in cases:
        with pytest.raises(ValueError, match=match):
            um.meng_albedo_hero_cuda(*args, 4, 100.0)
    assert um.LAUNCHES == before
