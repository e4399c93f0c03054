"""The port's closest hit (kernel K1's plain twin and the attribute recovery)
against the JAX package, on the CPU.

Oracles: ``intersect_rays_soa2`` (the packed-key XLA sweep with the same
tie rule), the Pallas kernel ``intersect_best_key(..., interpret=True)`` and
``intersect_rays_pallas(..., interpret=True)``.  XLA on the CPU contracts
``a*b + c`` into fused multiply-adds where the twin rounds twice, so a ray
that grazes an edge or sits on a quad's diagonal may resolve differently:
the hit/prim/mat comparisons allow no such flip at these seeds
(``edge_flip_budget`` 0, as tests/test_intersect_pallas.py uses), and the
triangle index may differ only between the two coplanar halves of one quad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.render import intersect as t_isect
from simple_spectral_torch.render import intersect_pallas as t_kernel
from simple_spectral_torch.render.vec import V3 as TV3
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.render.intersect import intersect_rays_pallas, intersect_rays_soa, intersect_rays_soa2
from simple_spectral_tpu.render.intersect_pallas import intersect_best_key
from simple_spectral_tpu.render.vec import V3
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

EPS = 1e-3
LANE_COUNTS = (1, 7, 130, 2049, 4096)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(scene="cornell-srgb", mode="rgb", width=8, height=8, spp=1)
    cfg = RenderConfig(**kw)
    j_scene = build_scene(cfg, build_color_tables(cfg))
    tcfg = TorchConfig(**kw)
    t_scene = t_build_scene(tcfg, t_build_tables(tcfg, device="cpu"), device="cpu")
    return j_scene, t_scene


def _rays(j_scene, n, seed, ignore_from_first_hit=False):
    """Origins inside the scene bounds, random unit directions; with
    ``ignore_from_first_hit`` the origins are surface points with their own
    primitive ignored (the bounce/shadow-ray case)."""
    rng = np.random.default_rng(seed)
    verts = np.asarray(j_scene.tri_verts).reshape(-1, 3)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o = rng.uniform(lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ignore = np.full((n,), -1, np.int32)
    if ignore_from_first_hit:
        ov = V3(*(jnp.asarray(o[:, a]) for a in range(3)))
        dv = V3(*(jnp.asarray(d[:, a]) for a in range(3)))
        first = intersect_rays_soa2(j_scene, ov, dv, jnp.asarray(ignore), EPS)
        dist = np.where(np.isfinite(np.asarray(first.dist)), np.asarray(first.dist), 0.0)
        o = (o + dist[:, None] * d).astype(np.float32)
        ignore = np.array(first.prim, np.int32)
        d = rng.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, ignore


def _jax_v3(a):
    return V3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _torch_v3(a):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _assert_same_winner(scene_j, tri_t, tri_j, hit_t, hit_j, prim_t, prim_j, mat_t, mat_j):
    np.testing.assert_array_equal(hit_t, hit_j)
    np.testing.assert_array_equal(prim_t, prim_j)
    np.testing.assert_array_equal(mat_t, mat_j)
    # a different triangle may win only as the other half of the same quad
    tri_prim = np.asarray(scene_j.tri_prim)
    diff = hit_j & (tri_t != tri_j)
    np.testing.assert_array_equal(tri_prim[tri_t[diff]], tri_prim[tri_j[diff]])
    assert diff.mean() <= 1e-3, f"{diff.sum()} lanes resolved to the other half of a quad"


@pytest.mark.parametrize("n", LANE_COUNTS)
@pytest.mark.parametrize("ignore", [False, True], ids=["no-ignore", "ignore-prim"])
def test_twin_key_matches_soa2_winner(scenes, n, ignore):
    j_scene, t_scene = scenes
    o, d, ign = _rays(j_scene, n, seed=n + 17 * ignore, ignore_from_first_hit=ignore)
    ref = intersect_rays_soa2(j_scene, _jax_v3(o), _jax_v3(d), jnp.asarray(ign), EPS)
    key = t_kernel.best_key_plain(
        t_scene.tri_verts, t_scene.tri_prim, _torch_v3(o), _torch_v3(d), torch.from_numpy(ign), EPS
    ).numpy()
    idx_mask = t_kernel.key_idx_mask(t_scene.n_tris)
    hit = key < t_kernel.INF_BITS
    tri = np.where(hit, key & idx_mask, 0)
    tri_prim, tri_mat = np.asarray(j_scene.tri_prim), np.asarray(j_scene.tri_mat)
    _assert_same_winner(
        j_scene, tri, np.asarray(ref.tri), hit, np.asarray(ref.hit),
        np.where(hit, tri_prim[tri], -1), np.asarray(ref.prim),
        np.where(hit, tri_mat[tri], 0), np.asarray(ref.mat),
    )
    # the key's distance prefix is the exact distance with idx bits dropped
    same = hit & (tri == np.asarray(ref.tri))
    dist_q = (key & ~idx_mask).view(np.float32)
    ref_q = (np.asarray(ref.dist).view(np.int32) & ~idx_mask).view(np.float32)
    np.testing.assert_allclose(dist_q[same], ref_q[same], rtol=1e-5)


@pytest.mark.parametrize("n", [7, 2049])
@pytest.mark.parametrize("ignore", [False, True], ids=["no-ignore", "ignore-prim"])
def test_exact_key_matches_xla_argmin(scenes, n, ignore):
    """K1's exact 64-bit key (the "xla" and "auto" routes) against the JAX
    "xla" sweep, ``intersect_rays_soa``: the same triangle wins, exact ties
    to the first index as ``jnp.argmin``, and the key carries the distance."""
    j_scene, t_scene = scenes
    o, d, ign = _rays(j_scene, n, seed=500 + n + 17 * ignore, ignore_from_first_hit=ignore)
    ref = intersect_rays_soa(j_scene, _jax_v3(o), _jax_v3(d), jnp.asarray(ign), EPS, need_attrs=False)
    key = t_kernel.best_key_plain(t_scene.tri_verts, t_scene.tri_prim, _torch_v3(o), _torch_v3(d),
                                  torch.from_numpy(ign), EPS, exact=True)
    assert key.dtype == torch.int64
    hit, tri, dist = (x.numpy() for x in t_kernel.key_parts(key, t_scene.n_tris, exact=True))
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_array_equal(np.where(hit, tri, 0), np.where(hit, np.asarray(ref.tri), 0))
    np.testing.assert_allclose(dist[hit], np.asarray(ref.dist)[hit], rtol=1e-5)
    assert np.isinf(dist[~hit]).all()


@pytest.mark.parametrize("n", LANE_COUNTS)
def test_twin_key_matches_pallas_interpret(scenes, n):
    j_scene, t_scene = scenes
    o, d, ign = _rays(j_scene, n, seed=1000 + n, ignore_from_first_hit=(n % 2 == 1))
    ref = np.asarray(
        intersect_best_key(j_scene.tri_verts, j_scene.tri_prim, _jax_v3(o), _jax_v3(d), jnp.asarray(ign), EPS,
                           interpret=True)
    )
    key = t_kernel.intersect_best_key(
        t_scene.tri_verts, t_scene.tri_prim, _torch_v3(o), _torch_v3(d), torch.from_numpy(ign), EPS
    ).numpy()
    idx_mask = t_kernel.key_idx_mask(t_scene.n_tris)
    tri_prim, tri_mat = np.asarray(j_scene.tri_prim), np.asarray(j_scene.tri_mat)
    hit, hit_r = key < t_kernel.INF_BITS, ref < t_kernel.INF_BITS
    tri, tri_r = np.where(hit, key & idx_mask, 0), np.where(hit_r, ref & idx_mask, 0)
    _assert_same_winner(
        j_scene, tri, tri_r, hit, hit_r,
        np.where(hit, tri_prim[tri], -1), np.where(hit_r, tri_prim[tri_r], -1),
        np.where(hit, tri_mat[tri], 0), np.where(hit_r, tri_mat[tri_r], 0),
    )


@pytest.mark.parametrize("need_attrs", [True, False], ids=["attrs", "no-attrs"])
def test_hit_record_matches_pallas_recovery(scenes, need_attrs):
    j_scene, t_scene = scenes
    n = 2049
    o, d, ign = _rays(j_scene, n, seed=5 + need_attrs, ignore_from_first_hit=True)
    ref = intersect_rays_pallas(j_scene, _jax_v3(o), _jax_v3(d), jnp.asarray(ign), EPS,
                                need_attrs=need_attrs, interpret=True)
    got = t_isect.intersect_rays_dispatch(t_scene, _torch_v3(o), _torch_v3(d), torch.from_numpy(ign), EPS,
                                          need_attrs=need_attrs, impl="pallas")
    tri, tri_r = got.tri.numpy(), np.asarray(ref.tri)
    _assert_same_winner(j_scene, tri, tri_r, got.hit.numpy(), np.asarray(ref.hit), got.prim.numpy(),
                        np.asarray(ref.prim), got.mat.numpy(), np.asarray(ref.mat))
    same = got.hit.numpy() & (tri == tri_r)
    # no-attrs: the keys' distances; the Pallas kernel projects the vertices
    # before subtracting the origin, so its distance carries a few ulp of the
    # scene's extent (~560) as absolute error
    atol = 0.0 if need_attrs else 2e-4
    np.testing.assert_allclose(got.dist.numpy()[same], np.asarray(ref.dist)[same], rtol=1e-5, atol=atol)
    if need_attrs:
        for a in range(3):
            np.testing.assert_array_equal(got.normal[a].numpy()[same], np.asarray(ref.normal[a])[same])
        np.testing.assert_allclose(got.st_s.numpy()[same], np.asarray(ref.st_s)[same], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.st_t.numpy()[same], np.asarray(ref.st_t)[same], rtol=1e-5, atol=1e-6)


def test_dense_impl_names_route_to_k1_and_scale_path_raises(scenes):
    _, t_scene = scenes
    # "auto" and "xla" take K1's exact key, "xla2" and "pallas" its quantized one
    for impl, arm in (("auto", "xla"), ("xla", "xla"), ("xla2", "pallas"), ("pallas", "pallas")):
        assert t_isect.resolve_intersect_impl(impl) == arm
        assert t_isect.resolve_intersect_impl(impl, t_scene) == arm
    assert t_isect.resolve_intersect_impl("cull") == "cull"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        t_isect.resolve_intersect_impl("bvh")


def test_cuda_wrapper_refuses_cpu_tensors(scenes, monkeypatch):
    """The six-component wrapper checks its tensors before it builds or
    loads the kernel, so CPU tensors raise without nvcc."""
    _, t_scene = scenes

    def no_build(*args):
        raise AssertionError("the kernel was built or loaded")

    monkeypatch.setattr(t_kernel.kernels, "load", no_build)
    o = TV3(*(torch.zeros(4) for _ in range(3)))
    d = TV3(*(torch.ones(4) for _ in range(3)))
    for exact in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            t_kernel.best_key_cuda(o, d, torch.zeros(4, dtype=torch.int32),
                                   t_scene.tri_verts.reshape(-1, 9).contiguous(), t_scene.tri_prim, EPS, exact)
