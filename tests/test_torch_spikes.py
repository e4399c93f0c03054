"""The port's counterparts of the JAX package's TPU spikes, on the CPU: the
fused bounce (kernel S1's twin) against the spike's ``_bounce_jnp``, and the
u32 gather (kernel gather_u32's twin) against the spikes' Pallas gathers in
interpret mode and their jnp bodies.

The spike writes a triangle row's kind as the int32 1 into its float32 rows,
so it compares the denormal 1.4e-45 with 1.0 and no lane ever hits; the
port's rows hold 1.0.  XLA on the CPU also flushes denormals to zero, and the
primitive ids in word 11 are denormals as floats, so there every id compares
equal to every other; the port compares them as bits.  To hold the twin's
bounce against ``_bounce_jnp`` on the port's rows, JAX is handed the same
rows with word 11 holding each id as a float value, which the spike's
comparisons and selections treat alike, and its ids are read back as
values.  XLA contracts ``a*b + c`` into fused multiply-adds and has its own
rsqrt, sin and cos: measured over four seeds of 4096 lanes, about 30 lanes
keep a distance one 64-ulp key step apart (2^-17 relative), no winning
primitive differs, and 7-17 shadow rays (at most 0.42%) resolve to the other
side of a light's edge (the light against the ceiling or a wall), so the
shadow primitive is held to 1% of lanes and wi to 1e-6 on the other lanes.

The build variants that ``tools.kernel_variants`` times on the card must
each undo one design choice of the committed CUDA sources: their texts are
checked here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from simple_spectral_torch import kernels
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.scene.library import build_scene as t_build_scene
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_torch.tools import bench_gather as tg
from simple_spectral_torch.tools import bench_megakernel as s1
from simple_spectral_torch.tools import kernel_variants
from tools.bench_megakernel import _bounce_jnp
from tools.bench_megakernel import scene_rows as spike_scene_rows
from tools.bench_pallas_gather import _dg0_kernel, _dg1_kernel

N = 4096
SHADOW_FLIPS = 0.01


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs several workers on one
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cornell():
    cfg = TorchConfig(scene="cornell", mode="rgb", width=64, height=64)
    scene = t_build_scene(cfg, t_build_tables(cfg, device="cpu"), device="cpu")
    rows_j, light_j, light_prim_j, _, _ = spike_scene_rows()
    return cfg, scene, (rows_j, light_j, light_prim_j)


def test_scene_rows_are_the_spikes_but_the_kind_word(cornell):
    _, scene, (rows_j, light_j, light_prim_j) = cornell
    rows, light, light_prim = s1.scene_rows(scene)
    rows = rows.numpy()
    np.testing.assert_array_equal(rows[:, 1:].view(np.int32), rows_j[:, 1:].view(np.int32))
    np.testing.assert_array_equal(light.numpy(), light_j)
    assert light_prim == light_prim_j
    np.testing.assert_array_equal(rows[:38, 0], 1.0)
    np.testing.assert_array_equal(rows[38:, 0], -1.0)
    assert (rows_j[:38, 0].view(np.int32) == 1).all()  # the spike's kind: the denormal 1.4e-45


_bounce = jax.jit(lambda rows, light, lp, o, d, ign, u: _bounce_jnp(rows, light, lp, o, d, ign, u),
                  static_argnums=(2,))


@pytest.mark.parametrize("seed", [0, 1])
def test_bounce_twin_matches_spike_on_corrected_rows(cornell, seed):
    cfg, scene, (_, light_j, light_prim) = cornell
    rows, light, _ = s1.scene_rows(scene)
    rays, u = s1.bounce_inputs(scene, cfg, N, seed)
    got = s1.bounce_plain(rows, light, rays, u).numpy()
    rows_j = rows.numpy().copy()
    rows_j[:, 11] = rows_j[:, 11].view(np.int32).astype(np.float32)  # ids as values for XLA's flush-to-zero
    r = rays.numpy()
    want = np.asarray(_bounce(rows_j, light_j, light_prim, r[0:3], r[3:6], r[6:7], u.numpy()))
    hit = np.isfinite(got[0])
    assert hit.sum() > 0.9 * N
    np.testing.assert_array_equal(hit, np.isfinite(want[0]))
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=2.0 ** -16)  # one key step at most
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].astype(np.int32))
    shadow = got[2].view(np.int32) == want[2].astype(np.int32)
    assert len(np.unique(got[2].view(np.int32))) > 5  # shadow rays hit the light and what blocks it
    assert (~shadow).mean() <= SHADOW_FLIPS
    np.testing.assert_allclose(got[3:7][:, shadow], want[3:7][:, shadow], atol=1e-6)
    np.testing.assert_array_equal(got[7], 0.0)


def test_bounce_on_the_spikes_rows_misses_everywhere_on_both_sides(cornell):
    cfg, scene, (rows_j, light_j, light_prim) = cornell
    rays, u = s1.bounce_inputs(scene, cfg, N, 0)
    got = s1.bounce_plain(torch.from_numpy(rows_j), torch.from_numpy(light_j), rays, u).numpy()
    r = rays.numpy()
    want = np.asarray(_bounce(rows_j, light_j, light_prim, r[0:3], r[3:6], r[6:7], u.numpy()))
    assert np.isinf(got[0]).all() and np.isinf(want[0]).all()
    np.testing.assert_array_equal(got[1:3].view(np.int32), want[1:3].view(np.int32))
    np.testing.assert_allclose(got[3:], want[3:], atol=1e-6)


def test_fused_bounce_runs_the_twin_on_the_cpu_and_the_kernel_wrapper_refuses_it(cornell):
    cfg, scene, _ = cornell
    rows, light, _ = s1.scene_rows(scene)
    rays, u = s1.bounce_inputs(scene, cfg, 64, 3)
    before = s1.LAUNCHES
    assert torch.equal(s1.bounce_fused(rows, light, rays, u), s1.bounce_plain(rows, light, rays, u))
    assert s1.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        s1.bounce_cuda(rows, light, rays, u)
    bound_ms, by, _ = s1.bound(s1.N)
    assert by == "operations" and 0.005 < bound_ms < 0.05


# --- the u32 gather ---


def _table(rng, t):
    return rng.integers(0, 1 << 30, t, dtype=np.int64).astype(np.uint32)


@pytest.mark.parametrize("axis", [0, 1])
def test_gather_twin_matches_pallas_dynamic_gather(axis):
    rows, cols = 2048, 128
    rng = np.random.default_rng(axis)
    table = _table(rng, rows * cols)
    idx = rng.integers(0, rows if axis == 0 else cols, (rows, cols)).astype(np.int32)
    kern = _dg0_kernel if axis == 0 else _dg1_kernel
    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.uint32), interpret=True)(
        jnp.asarray(table.reshape(rows, cols)), jnp.asarray(idx))
    mask = (rows if axis == 0 else cols) - 1
    got = tg.gather_u32(torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx), rows, cols, axis, mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("pattern", ["random", "all-zero", "coherent"])
def test_gather_twin_matches_flat_and_lane_takes(pattern):
    """The S3 bodies: ``bench_gather2``'s flat take and the lane take from
    the 8-row broadcast table of ``bench_gather3`` / ``bench_rng_gather``."""
    t, n = tg.T, 65536
    rng = np.random.default_rng(7)
    table = _table(rng, t)
    if pattern == "random":
        idx = rng.integers(0, t, n)
    elif pattern == "all-zero":
        idx = np.zeros(n, np.int64)
    else:
        idx = (np.arange(n) // 64 * 64 + rng.integers(0, 64, n)) % t
    idx = idx.astype(np.int32)
    got = tg.gather_u32(torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx), n, 1, 0, t - 1)
    got = got.numpy().reshape(-1).view(np.uint32)
    tab = jnp.asarray(table)
    np.testing.assert_array_equal(got, np.asarray(jnp.take(tab, jnp.asarray(idx), axis=0)))
    tab8 = jnp.broadcast_to(tab[None, :], (8, t))
    lanes = jnp.take_along_axis(tab8, jnp.bitwise_and(jnp.asarray(idx), t - 1).reshape(8, n // 8), axis=1,
                                mode="promise_in_bounds")
    np.testing.assert_array_equal(got, np.asarray(lanes).reshape(-1))


def test_gather_refuses_masks_that_leave_the_table():
    table = torch.zeros(1024, dtype=torch.int32)
    idx = torch.zeros(64, dtype=torch.int32)
    for rows, cols, axis, mask in ((64, 1, 0, 2047), (64, 1, 0, 1000), (8, 8, 1, 15), (4, 16, 0, 127)):
        with pytest.raises(ValueError, match="mask"):
            tg.gather_u32(table, idx, rows, cols, axis, mask)
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_u32_cuda(table, idx, 64, 1, 0, 1023)


@pytest.mark.parametrize("tool", ["bench_megakernel", "bench_gather"])
def test_entry_points_run_on_the_cpu_at_a_tiny_size(tool, capsys):
    if tool == "bench_megakernel":
        rc = s1.main(["--device", "cpu", "--lanes", "1024"])
    else:
        rc = tg.main(["--device", "cpu", "--size", "16", "--max-depth", "3", "--lanes", "1024"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "not measured" in out
    assert out.strip().splitlines()[-1].startswith("{")


def test_texel_indices_are_the_merged_fetch_and_the_hook_is_removed():
    from simple_spectral_torch.render import integrator

    geometry = integrator._geometry_phase
    table, idx = tg.texel_indices("cpu", size=8, max_depth=3)
    assert integrator._geometry_phase is geometry
    assert idx.shape == (2 * 8 * 8,) and idx.dtype == torch.int32
    assert table.numel() == 512 * 512 and 0 <= int(idx.min()) and int(idx.max()) < table.numel()
    assert len(torch.unique(idx)) > 4


@pytest.mark.parametrize("kernel, name", [(k, n) for k in sorted(kernel_variants.VARIANTS)
                                          for n in kernel_variants.VARIANTS[k]])
def test_kernel_variants_apply_to_the_sources(kernel, name):
    """Each build variant's old text is in the committed source, or a header
    it includes, exactly once, so the variant differs from the committed
    kernel in that choice alone."""
    texts = kernel_variants.source_texts(kernel)
    assert next(iter(texts)) == kernel_variants.SOURCES[kernel]
    variant = kernel_variants.variant_texts(texts, kernel_variants.VARIANTS[kernel][name])
    assert variant != texts and variant.keys() == texts.keys()
    with pytest.raises(ValueError, match="exactly once"):
        kernel_variants.variant_texts(variant, [("no such text", "")])


def test_library_path_follows_the_included_headers(tmp_path):
    """A kernel's library is named by the hash of its source and of the
    headers it includes, so an edited header is rebuilt, not loaded stale
    (no nvcc needed: only the names are computed)."""
    src, header, nested = tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return g(); }\n')
    header.write_text('#pragma once\n#include "b.cuh"\n__device__ int g() { return h(); }\n')
    nested.write_text("#pragma once\n__device__ int h() { return 1; }\n")
    assert kernels.includes(str(src)) == [str(header), str(nested)]
    first = kernels.library_path(str(src))
    assert kernels.library_path(str(src)) == first
    nested.write_text("#pragma once\n__device__ int h() { return 2; }\n")
    second = kernels.library_path(str(src))
    header.write_text(header.read_text() + "// edited\n")
    third = kernels.library_path(str(src))
    assert len({first, second, third}) == 3
    assert all(os.path.basename(p).startswith("k-") for p in (first, second, third))
    # the port's own kernels: K1 and S1 share the sweep's header
    for name in ("intersect_best_key.cu", "bounce_fused.cu"):
        assert [os.path.basename(h) for h in kernels.includes(kernels.source_path(name))] == ["closest_hit.cuh"]
