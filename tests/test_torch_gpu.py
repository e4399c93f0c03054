"""The port on a CUDA card: kernels K1 (both key widths), K2, S1 and
gather_u32 against their plain twins, tiny renders through K1 and K2 against
the same renders through the twins on the CPU, and the train step on the card
against the CPU.  Imports nothing of JAX, so it runs where only
the port is installed:

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
from simple_spectral_torch.render.renderer import render_accumulate
from simple_spectral_torch.render.trainstep import forward_backward_step
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.scene.library import build_scene
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
