"""The port's stage and host benches (``simple_spectral_torch/tools/``
``diag_cfg1``, ``bwd_bisect``, ``texel_q32_check``, ``texture_micro``,
``pack_micro``, ``gather_micro``, ``ctx_gather``) against the JAX tools they
replace (``tools/diag_cfg1.py``, ``tools/bench_bwd_bisect.py``,
``tools/texel_q32_check.py``, ``tools/bench_texture_micro.py``,
``tools/bench_pack_micro.py``, ``tools/bench_gather_micro.py``,
``tools/bench_ctx_gather.py``), on the CPU.

* Each port tool's table equals the JAX tool's: the JAX tool's ``main`` runs
  with its heavy calls (timer, round trip, scene and table builds, steps)
  replaced by recorders, and what they record (labels, configurations,
  lanes, pixels, keys, rays, K, ``SPP``, ``n_idx``, and for ``bwd_bisect``
  which integrator names were stubbed when each row was traced) is held
  against the port's rows.  The gather tools' tables equal the JAX tools'
  but for the rows eager torch cannot tell apart (``LEFT_OUT``).
* The draws: the JAX gather tools run at a small N and T, with
  ``jax.random`` and numpy's ``default_rng`` recording what they draw, and
  the port's draws at the same sizes are equal, uint32 included; the port's
  ``randint`` equals JAX's at spans above 2^16 too.
* Each row body of the gather tools equals a numpy computation of the same
  values at a small N; the f16 pack and unpack are exact.
* ``bwd_bisect``'s stubbed rows run their stubs through the real step, which
  stays finite and keeps a non-zero ``albedo_values`` gradient; the JAX
  tool's ``fake_xyz`` raises ``TypeError`` on the call the JAX integrator
  makes, and the port's takes it.
* ``texel_q32_check`` on a 32x32 crop gives the JAX tool's figures within
  the bound the standing q32 departure gives (see
  ``test_texel_q32_figures_match_the_jax_tools``).  The JAX tool's decode is
  wrapped in one ``jax.jit``: the file's one JAX compile of a render
  function.
* Each tool's ``main`` at a tiny size on the CPU writes its keys; a row
  made to raise leaves an ``error`` entry and exit 1; without a card the
  tools exit 1.
"""

import dataclasses
import inspect
import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch import random as trandom
from simple_spectral_torch.render import integrator as tint
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_torch.tools import bwd_bisect as tbb
from simple_spectral_torch.tools import ctx_gather as tcg
from simple_spectral_torch.tools import diag_cfg1 as tdc
from simple_spectral_torch.tools import gather_micro as tgm
from simple_spectral_torch.tools import gather_rows
from simple_spectral_torch.tools import pack_micro as tpm
from simple_spectral_torch.tools import texel_q32_check as ttq
from simple_spectral_torch.tools import texture_micro as ttm
from simple_spectral_tpu.render import integrator as jint
from simple_spectral_tpu.render import renderer as jrend
from simple_spectral_tpu.render import trainstep as jtrain
from simple_spectral_tpu.scene import library as jlib
from simple_spectral_tpu.spectra import colorimetry as jcolor
from simple_spectral_tpu.spectra import upsample_jakob as jup

# the small sizes the JAX gather tools are run at: indices per bounce, table rows
SMALL_N, SMALL_T = 64, 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def key_words(key) -> list:
    return [int(w) for w in np.asarray(key, np.uint32).ravel()]


class Timer:
    """Stands in for ``timeit_chained`` and ``measure_rtt``: records each
    timed row's label and K (with the last step's record, if any) and
    returns ``dt`` seconds."""

    def __init__(self, monkeypatch, module, dt=1e-6):
        self.rows, self.last, self.dt = [], {}, dt
        monkeypatch.setattr(module, "timeit_chained", self.timeit)
        monkeypatch.setattr(module, "measure_rtt", lambda: 0.0)

    def timeit(self, label, step, state0, K=15, rtt=None, quiet=False):
        self.rows.append(dict(self.last, label=label, K=K))
        return self.dt


class Draws:
    """Records what ``jax.random.randint``/``uniform`` and numpy's
    ``default_rng`` generators draw, in order: [(name, array)]."""

    def __init__(self, monkeypatch):
        self.seen = []
        real_randint, real_uniform, real_rng = jax.random.randint, jax.random.uniform, np.random.default_rng
        draws = self

        def randint(*a, **kw):
            return draws.add("randint", real_randint(*a, **kw))

        def uniform(*a, **kw):
            return draws.add("uniform", real_uniform(*a, **kw))

        class Rng:
            def __init__(self, seed):
                self.g = real_rng(seed)

            def __getattr__(self, name):
                return lambda *a, **kw: draws.add(name, getattr(self.g, name)(*a, **kw))

        monkeypatch.setattr(jax.random, "randint", randint)
        monkeypatch.setattr(jax.random, "uniform", uniform)
        monkeypatch.setattr(np.random, "default_rng", Rng)

    def add(self, name, x):
        self.seen.append((name, np.asarray(x)))
        return x


# --------------------------------------------------------------------------- (a) the tables


def test_diag_cfg1_table_is_the_jax_tools(monkeypatch):
    import tools.diag_cfg1 as jdc

    timer = Timer(monkeypatch, jdc)
    monkeypatch.setattr(jdc, "RESULTS", [])
    monkeypatch.setattr(jcolor, "build_color_tables", lambda cfg: "tables")
    monkeypatch.setattr(jlib, "build_scene", lambda cfg, tables: "scene")

    def step(name):
        def fn(scene, tables, cfg, key, px, *rest):
            timer.last = dict(step=name, cfg=cfg, key=key_words(key), px=np.asarray(px), spp=rest[-1])
            return (jnp.float32(0.0), {}) if name == "fwd+bwd" else jnp.float32(0.0)
        return fn

    monkeypatch.setattr(jtrain, "forward_backward_step", step("fwd+bwd"))
    monkeypatch.setattr(jtrain, "forward_only_step", step("fwd-only"))
    monkeypatch.setattr(jrend, "_render_chunk", step("render-only"))
    monkeypatch.setattr(sys, "argv", ["diag_cfg1.py"])
    jdc.main()
    assert jdc.RESULTS[0]["label"] == tdc.FOLD_LABEL and set(jdc.RESULTS[0]) == {"label", "ms"}
    got = tdc.table()
    assert [r["label"] for r in jdc.RESULTS[1:]] == [g[0] for g in got]
    cfgs = tdc.configs()
    for w, jrow, (label, cname, step_name, lanes) in zip(timer.rows, jdc.RESULTS[1:], got, strict=True):
        cfg = cfgs[cname]
        assert w["step"] == step_name and asdict(w["cfg"]) == asdict(cfg), label
        np.testing.assert_array_equal(w["px"], tdc.pixels(cfg, lanes, "cpu").numpy())
        assert w["spp"] == 1 and w["K"] == tdc.K_CALLS, label
        assert w["key"] == key_words(tdc.call_key(0)), label  # the s0 call's key, i = 0
        assert jrow["mrays_s"] == tdc.rays_of(cfg, lanes), label  # rays over 1e-6 s


def test_diag_cfg1_fixed_ms_is_the_intercept():
    assert tdc.line_fit([(16384, 3.0), (65536, 6.0), (262144, 18.0)]) == pytest.approx((2.0, 6.103515625e-05))
    assert tdc.line_fit([(16384, 3.0)]) is None


def test_bwd_bisect_table_is_the_jax_tools(monkeypatch):
    import tools.bench_bwd_bisect as jbb

    timer = Timer(monkeypatch, jbb)
    monkeypatch.setattr(jbb, "RESULTS", [])
    monkeypatch.setattr(jbb, "build_color_tables", lambda cfg: "tables")
    monkeypatch.setattr(jbb, "build_scene", lambda cfg, tables: "scene")

    def loss_fn(scene, tables, cfg, key, px, target, spp, remat):
        # traced once per row, when the JAX tool's patched globals are read
        timer.last = dict(cfg=cfg, px=np.asarray(px), target=target.shape, spp=spp, remat=remat,
                          stubs={tbb.XYZ: jint.specradflux_to_ciexyz_hero_soa is jbb.fake_xyz,
                                 tbb.PRECOMPUTE: jint.precompute_constant_spectra is jbb.fake_precompute})
        return lambda params: params["a"] * 0.0

    monkeypatch.setattr(jtrain, "_loss_fn", loss_fn)
    monkeypatch.setattr(jtrain, "material_params", lambda scene: {"a": jnp.float32(1.0)})
    monkeypatch.setattr(sys, "argv", ["bench_bwd_bisect.py"])
    jbb.main()
    assert [r["label"] for r in jbb.RESULTS] == [r.label for r in tbb.ROWS]
    for w, row in zip(timer.rows, tbb.ROWS, strict=True):
        cfg = tbb.config().replace(remat_cache=row.remat_cache)
        lanes = tbb.lanes_of(cfg)
        assert w["label"] == row.label and asdict(w["cfg"]) == asdict(cfg), row.label
        assert w["stubs"] == {name: name in row.stubs for name in (tbb.XYZ, tbb.PRECOMPUTE)}, row.label
        assert (w["px"] == np.arange(lanes)).all() and w["target"] == (lanes, 3), row.label
        assert (w["spp"], w["remat"], w["K"]) == (tbb.SPP, "none", tbb.K_CALLS), row.label
    assert lanes == 262144
    assert jint.specradflux_to_ciexyz_hero_soa is jbb.ORIG_XYZ


def test_texture_micro_table_is_the_jax_tools(monkeypatch):
    import tools.bench_texture_micro as jtm

    timer = Timer(monkeypatch, jtm)
    draws = Draws(monkeypatch)
    cfgs = []
    monkeypatch.setattr(jtm, "N", SMALL_N)
    monkeypatch.setattr(jtm, "build_color_tables", lambda cfg: cfgs.append(cfg) or "tables")
    monkeypatch.setattr(jtm, "build_scene",
                        lambda cfg, tables: SimpleNamespace(texture=jnp.zeros((SMALL_T,), jnp.uint32)))
    monkeypatch.setattr(jtm, "precompute_basis_hero", lambda tables, cfg, lam0: None)
    jtm.main()
    assert [r["label"] for r in timer.rows] == list(ttm.LABELS)
    assert all(r["K"] == ttm.K_CALLS for r in timer.rows) and jtm.D == gather_rows.D
    assert [asdict(c) for c in cfgs] == [asdict(ttm.config())]
    (n1, idx), (n2, u), (n3, rr) = draws.seen
    tex_idx, lam0, t_rr = ttm.draws(SMALL_N, SMALL_T, "cpu")
    assert (n1, n2, n3) == ("randint", "uniform", "uniform")
    np.testing.assert_array_equal(tex_idx.numpy(), idx)
    np.testing.assert_array_equal(lam0.numpy(), np.float32(380.0) + u * np.float32(395.0))
    np.testing.assert_array_equal(t_rr.numpy(), rr)


def test_pack_micro_table_is_the_jax_tools(monkeypatch, tmp_path):
    import tools.bench_pack_micro as jpm

    timer = Timer(monkeypatch, jpm, dt=1.0)
    draws = Draws(monkeypatch)
    monkeypatch.setattr(jpm, "N", SMALL_N)
    monkeypatch.setattr(jpm, "T", SMALL_T)
    monkeypatch.setattr(jpm, "RESULTS", [])
    monkeypatch.setattr(sys, "argv", ["bench_pack_micro.py", str(tmp_path / "jax.json")])
    jpm.main()
    seen = list(draws.seen)  # the port's numpy draws below are recorded too
    labels = list(tpm.row_fns(torch.zeros((4, 3)), torch.zeros((4, 12))))
    assert [r["label"] for r in jpm.RESULTS] == labels
    assert all(r["K"] == tpm.K_CALLS for r in timer.rows)
    # n_idx = N, run's default, bound when the module was imported: the full N
    assert all(r["ns_per_index"] == round(1.0 / tpm.N * 1e9, 3) for r in jpm.RESULTS)
    assert all(n_idx == SMALL_N for _, _, n_idx in tpm.make_rows(SMALL_N, "cpu"))
    with open(tmp_path / "jax.json") as f:
        head = json.load(f)
    assert head["n_indices"] == SMALL_N and head["table_rows"] == SMALL_T
    assert [n for n, _ in seen] == ["integers", "normal", "integers", "random"]
    idx, rows3, rows12 = tpm.draws(SMALL_N, SMALL_T)
    (_, d_idx), (_, d_rows3), (_, d_ids), (_, d_w) = seen
    np.testing.assert_array_equal(idx, d_idx.astype(np.int32))
    np.testing.assert_array_equal(rows3, d_rows3.astype(np.float32))
    np.testing.assert_array_equal(rows12, np.concatenate([d_ids.astype(np.float32), d_w], axis=1))


def test_gather_micro_table_is_the_jax_tools(monkeypatch):
    import tools.bench_gather_micro as jgm

    timer = Timer(monkeypatch, jgm)
    draws = Draws(monkeypatch)
    monkeypatch.setattr(jgm, "N", SMALL_N)
    monkeypatch.setattr(jgm, "T", SMALL_T)
    jgm.main()
    labels = [r["label"] for r in timer.rows]
    got = tgm.draws(SMALL_N, "cpu", t=SMALL_T)
    assert [lb for lb in labels if lb not in tgm.LEFT_OUT] == list(tgm.row_calls(got))
    assert set(tgm.LEFT_OUT) <= set(labels) and tgm.ONE_GATHER in labels
    assert all(r["K"] == tgm.K_CALLS for r in timer.rows) and jgm.D == gather_rows.D
    names = ["tex_u32", "tex_rows", "tex_planar", "idx", "bh"]
    assert [n for n, _ in draws.seen] == ["randint", "uniform", "uniform", "randint", "uniform"]
    assert draws.seen[0][1].dtype == np.uint32
    for name, (_, want) in zip(names, draws.seen, strict=True):
        want = want.astype(np.int64) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(got[name].numpy(), want, err_msg=name)


def test_ctx_gather_table_is_the_jax_tools(monkeypatch):
    import tools.bench_ctx_gather as jcg

    timer = Timer(monkeypatch, jcg, dt=1.0)
    draws = Draws(monkeypatch)
    monkeypatch.setattr(jcg, "N", SMALL_N)
    monkeypatch.setattr(jcg, "T", SMALL_T)
    monkeypatch.setattr(jcg, "RESULTS", [])
    monkeypatch.setattr(sys, "argv", ["bench_ctx_gather.py"])
    jcg.main()
    seen = list(draws.seen)  # the port's numpy draws below are recorded too
    data = tcg.draws(SMALL_N, SMALL_T)
    got = tcg.rows(*(torch.from_numpy(a) for a in data))
    want = [r for r in jcg.RESULTS if r["label"] not in tcg.LEFT_OUT]
    assert set(tcg.LEFT_OUT) <= {r["label"] for r in jcg.RESULTS}
    assert [r["label"] for r in want] == [g[0] for g in got]
    assert [r["ns_per_index"] for r in want] == [round(1.0 / n_idx * 1e9, 3) for _, _, n_idx in got]
    assert all(r["K"] == tcg.K_CALLS for r in timer.rows)
    assert [n for n, _ in seen] == ["normal", "integers", "integers", "random"]
    (_, table), (_, stack), (_, idx1), (_, rand) = seen
    for mine, theirs in zip(data, (table.astype(np.float32), stack.astype(np.int32), idx1.astype(np.int32),
                                   rand < 0.1), strict=True):
        np.testing.assert_array_equal(mine, theirs)


# --------------------------------------------------------------------------- (b) the draws and the row bodies


@pytest.mark.parametrize("span, dtype", [(SMALL_T, jnp.int32), (1 << 24, jnp.uint32), (262144, jnp.int32),
                                         (70000, jnp.int32), (100000, jnp.int32), (200, jnp.int32)])
def test_randint_is_jaxs(span, dtype):
    """Spans above 2^16 square the multiplier past 2^32, where JAX's uint32
    wraps: the port wraps it too."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (3, 50), 0, span, dtype)).astype(np.int64)
    got = trandom.randint(trandom.PRNGKey(0), (3, 50), 0, span).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_f16_bits_round_trip_exactly():
    bits = torch.arange(1 << 16, dtype=torch.int32)
    want = np.arange(1 << 16).astype(np.uint16).view(np.float16).astype(np.float32)
    np.testing.assert_array_equal(tpm.f16_from_bits(bits).numpy(), want)  # NaNs in the same places
    x = torch.from_numpy(np.random.default_rng(5).normal(size=4096).astype(np.float32))
    np.testing.assert_array_equal(tpm.f16_bits(x).numpy(), x.numpy().astype(np.float16).view(np.uint16))


def close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_texture_micro_rows_are_numpys():
    from simple_spectral_tpu.spectra.colorimetry import srgb_to_lrgb_np

    cfg = ttm.config()
    tables = t_build_tables(cfg, device="cpu")
    words = trandom.randint(trandom.PRNGKey(7), (SMALL_T,), 0, 1 << 24)
    tex_idx, lam0, rr = ttm.draws(SMALL_N, SMALL_T, "cpu")
    fns = ttm.row_fns(SimpleNamespace(texture=words), tables, cfg, lam0, rr)
    from simple_spectral_torch.render.shading import precompute_basis_hero

    bh = precompute_basis_hero(tables, cfg, lam0).numpy().astype(np.float64)
    w, idx = words.numpy(), tex_idx.numpy()
    rgb = [srgb_to_lrgb_np(((w >> s) & 0xFF).astype(np.float32) / np.float32(255.0)).astype(np.float64)
           for s in (16, 8, 0)]
    want = {
        ttm.LABELS[0]: sum(w[i].astype(np.float64).sum() for i in idx),
        ttm.LABELS[1]: sum((rgb[0][i] + rgb[1][i] + rgb[2][i]).sum() for i in idx),
        ttm.LABELS[2]: sum((bh[0] * rgb[0][i] + bh[1] * rgb[1][i] + bh[2] * rgb[2][i]).sum() for i in idx),
        ttm.LABELS[3]: len(idx) * srgb_to_lrgb_np(rr.numpy()).astype(np.float64).sum(),
    }
    for label, fn in fns.items():
        close(gather_rows.bounce_sum(fn, tex_idx), want[label])


def test_pack_micro_rows_are_numpys():
    idx, rows3, rows12 = tpm.draws(SMALL_N, SMALL_T)
    c16 = rows3.astype(np.float16)
    b16 = c16.view(np.uint16).astype(np.uint32)
    words2 = np.stack([(b16[:, 0] << 16) | b16[:, 1], b16[:, 2]], axis=1)
    w0, w1 = tpm.pack2(torch.from_numpy(rows3))
    np.testing.assert_array_equal(torch.stack([w0, w1], 1).numpy(), words2.view(np.int32))
    ids, wts = rows12[:, :6].astype(np.uint32), rows12[:, 6:].astype(np.float16)
    words6 = (ids << 16) | wts.view(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(tpm.pack6(torch.from_numpy(rows12)).numpy(), words6.view(np.int32))
    for got, want in zip(tpm.unpack2(w0, w1), c16.T, strict=True):  # the unpack is exact
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))

    g = c16[idx].astype(np.float64)
    want = [rows3[idx].sum(), g.sum(), g.sum(), rows12[idx].sum(),
            (ids[idx].astype(np.float64) + wts[idx].astype(np.float64)).sum(),
            rows12[idx, :6].sum(), rows12[idx, :2].sum(), rows12[idx, :1].sum(),
            words2[idx, 0].astype(np.float32).astype(np.float64).sum()]
    fns = tpm.row_fns(torch.from_numpy(rows3), torch.from_numpy(rows12))
    for (label, fn), w in zip(fns.items(), want, strict=True):
        close(fn(torch.from_numpy(idx)), w)


def test_gather_micro_rows_are_numpys():
    d = tgm.draws(SMALL_N, "cpu", t=SMALL_T)
    u32, rows, planar, idx, bh = (d[k].numpy().astype(np.float64) if k != "idx" else d[k].numpy()
                                  for k in ("tex_u32", "tex_rows", "tex_planar", "idx", "bh"))
    want = [sum(u32[i].sum() for i in idx), sum(rows[i].sum() for i in idx),
            sum(planar[:, i].sum() for i in idx), rows[idx.reshape(-1)].sum(),
            sum((bh[0] * rows[i, 0] + bh[1] * rows[i, 1] + bh[2] * rows[i, 2]).sum() for i in idx)]
    for (label, call), w in zip(tgm.row_calls(d).items(), want, strict=True):
        close(call(), w)


def test_ctx_gather_rows_are_numpys():
    table, stack, idx1, mask = tcg.draws(SMALL_N, SMALL_T)
    t64 = table.astype(np.float64)
    want = [t64[idx1].sum(), sum(t64[i].sum() for i in stack), t64[stack.reshape(-1)].sum(),
            sum(t64.reshape(-1)[3 * i + c].sum() for i in stack for c in range(3)),
            sum(t64[np.where(mask, i, 0)].sum() for i in stack),
            sum((t64[i, 0] * 0.5 + t64[i, 1] + t64[i, 2]).sum() for i in stack)]
    got = tcg.rows(*(torch.from_numpy(a) for a in (table, stack, idx1, mask)))
    for (label, call, _), w in zip(got, want, strict=True):
        close(call(), w)


# --------------------------------------------------------------------------- (c) bwd_bisect's stubs


def test_bwd_bisect_rows_run_their_stubs(monkeypatch, tmp_path):
    """Each row's one call through the real step at 8x8, depth 2: the stubs
    it names ran and no other, the loss and gradients are finite, and the
    albedo gradient is not zero (the precompute stub keeps its path)."""
    calls = {tbb.XYZ: 0, tbb.PRECOMPUTE: 0}
    runs = []
    for attr, name in (("fake_xyz", tbb.XYZ), ("fake_precompute", tbb.PRECOMPUTE)):
        def counted(*a, _fake=getattr(tbb, attr), _name=name, **kw):
            calls[_name] += 1
            return _fake(*a, **kw)
        monkeypatch.setattr(tbb, attr, counted)

    def one_call(step, k_calls, devices):
        before = dict(calls)
        loss, grads = step(0)
        runs.append(({k: calls[k] - before[k] for k in calls}, loss, grads))
        return {"seconds_per_call": 1e-3, "k1_launches_per_call": 0, "k2_launches_per_call": 0, "peak_bytes": None}

    monkeypatch.setattr(tbb, "time_calls", one_call)
    originals = (tint.specradflux_to_ciexyz_hero_soa, tint.precompute_constant_spectra)
    assert tbb.main([str(tmp_path / "out.json"), "--device", "cpu", "--size", "8", "--max-depth", "2"]) == 0
    assert (tint.specradflux_to_ciexyz_hero_soa, tint.precompute_constant_spectra) == originals
    for row, (ran, loss, grads) in zip(tbb.ROWS, runs, strict=True):
        assert {k: v > 0 for k, v in ran.items()} == {k: k in row.stubs for k in ran}, (row.label, ran)
        assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values()), row.label
        assert grads["albedo_values"].abs().sum() > 0, row.label


def test_the_jax_fake_xyz_rejects_the_integrators_call():
    """``tools/bench_bwd_bisect.py``'s ``fake_xyz`` has no ``lambda_min``,
    which the JAX integrator passes: its stubbed rows raise TypeError."""
    import tools.bench_bwd_bisect as jbb

    assert "lambda_min=cfg.lambda_min" in inspect.getsource(jint.trace_lanes)
    flux = np.arange(8, dtype=np.float32).reshape(4, 2)
    lam0 = np.full(2, 500.0, np.float32)
    with pytest.raises(TypeError, match="lambda_min"):
        jbb.fake_xyz(None, jnp.asarray(flux), jnp.asarray(lam0), 4, 10.0, lambda_min=360.0)
    got = tbb.fake_xyz(None, torch.from_numpy(flux), torch.from_numpy(lam0), 4, 10.0, lambda_min=360.0)
    np.testing.assert_array_equal(got.numpy(), np.stack([flux.sum(0)] * 3))


# --------------------------------------------------------------------------- (d) texel_q32_check


CROP = 32
# the q32 decode's standing departure from JAX's, held in tests/test_torch_jakob.py
DECODE_ATOL = 2e-6


def test_texel_q32_figures_match_the_jax_tools(monkeypatch, tmp_path):
    """Both tools on the texture's top-left 32x32 texels.  The standing
    departure (tests/test_torch_jakob.py): a q32 word may move by one code
    of one field, and the decodes agree within 2e-6.  So each figure
    agrees within 2e-6 plus, where words moved, one code's move
    (``texel_q32_check.bounds``): whole for a max or a quantile, over the
    texels (or a block's 256) for a mean, scaled for XYZ."""
    import PIL.Image

    import tools.texel_q32_check as jtq

    real_open, real_pack = PIL.Image.open, jup.jakob_q32_pack
    packs = []
    monkeypatch.setattr(PIL.Image, "open", lambda *a, **kw: real_open(*a, **kw).crop((0, 0, CROP, CROP)))
    monkeypatch.setattr(jup, "jakob_q32_eval_soa", jax.jit(jup.jakob_q32_eval_soa, static_argnums=(3, 4)))
    monkeypatch.setattr(jup, "jakob_q32_pack", lambda *c: packs.append(real_pack(*c)) or packs[-1])
    monkeypatch.setattr(sys, "argv", ["texel_q32_check.py", str(tmp_path / "jax.json")])
    jtq.main()
    assert ttq.main([str(tmp_path / "port.json"), "--crop", str(CROP), "--device", "cpu"]) == 0
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["texels"] == want["texels"] == CROP * CROP and got["texture"] == want["texture"]

    cfg = ttq.config()
    tables = t_build_tables(cfg, device="cpu")
    *_, words, meta = ttq.pack(ttq.load_texture(cfg, CROP), tables.jakob, "cpu")
    (j_words, _), = packs
    moved = int((words != j_words).sum())  # 1 of 1024 here (59 of 262144 on the whole texture)
    for a, b in zip(words[words != j_words], j_words[words != j_words]):  # by one code of one field
        fields = [abs(int(a >> s & m) - int(b >> s & m)) for s, m in ((22, 0x3FF), (11, 0x7FF), (0, 0x7FF))]
        assert sorted(fields) == [0, 0, 1], (hex(a), hex(b))
    bounds = ttq.bounds(tables, meta, moved, CROP * CROP, DECODE_ATOL)
    for fig, keys in bounds.items():
        assert set(got[fig]) == set(want[fig]) == set(keys)
        for k, bound in keys.items():
            assert abs(got[fig][k] - want[fig][k]) <= bound, (fig, k, got[fig][k], want[fig][k], bound, moved)


# --------------------------------------------------------------------------- (e) the entry points


TINY_GATHER = ["--n", "64", "--calls", "1"]
RUNS = {
    "diag_cfg1": (tdc, ["--size", "4", "--max-depth", "1", "--lanes", "16", "32", "--calls", "1"]),
    "bwd_bisect": (tbb, ["--size", "4", "--max-depth", "1", "--calls", "1"]),
    "texel_q32_check": (ttq, ["--crop", "16"]),
    "texture_micro": (ttm, TINY_GATHER),
    "pack_micro": (tpm, TINY_GATHER),
    "gather_micro": (tgm, TINY_GATHER),
    "ctx_gather": (tcg, TINY_GATHER),
}
LAUNCHES = {"k1_launches_per_call", "k2_launches_per_call", "peak_bytes"}
# the JAX tools' keys (tools/diag_cfg1.py:28-30, :111-114; bench_bwd_bisect.py:70-71, :105-107;
# texel_q32_check.py:82-103; bench_pack_micro.py:38-39, :131-135; bench_ctx_gather.py:40-41, :149-152; the
# texture and gather micro-benches write no file) without the round trip, with the port's additions
KEYS = {
    "diag_cfg1": ({"device", "results", "fixed_ms"}, {"label", "ms", "mrays_s"}),
    "bwd_bisect": ({"device", "spp", "results"}, {"label", "ms_per_call"}),
    "texture_micro": ({"device", "results"}, {"label", "ms"}),
    "pack_micro": ({"device", "n_indices", "table_rows", "results"}, {"label", "ms", "ns_per_index"}),
    "gather_micro": ({"device", "results"}, {"label", "ms"}),
    "ctx_gather": ({"device", "results"}, {"label", "ms", "ns_per_index"}),
}
TEXEL_KEYS = {"texture", "texels", "format", "pointwise_refl_err", "per_texel_xyz_err", "block16_mean_Y_err",
              "parity_block_tolerance_note", "device"}


def _run(tool, argv, tmp_path):
    out = tmp_path / "out.json"
    rc = tool.main([str(out), "--device", "cpu", *argv])
    with open(out) as f:
        return rc, json.load(f)


@pytest.mark.parametrize("name", list(RUNS))
def test_main_writes_its_keys(name, tmp_path):
    tool, argv = RUNS[name]
    rc, got = _run(tool, argv, tmp_path)
    assert rc == 0 and got["device"] == "cpu"
    if name == "texel_q32_check":
        assert set(got) == TEXEL_KEYS and got["texels"] == 16 * 16
        return
    head, row_keys = KEYS[name]
    assert set(got) == head
    rows = got["results"]
    if name == "diag_cfg1":
        assert rows[0]["label"] == tdc.FOLD_LABEL and set(rows[0]) == {"label", "ms"}
        rows = rows[1:]
        assert [r["label"] for r in rows] == [t[0] for t in tdc.table((16, 32))]
        assert set(got["fixed_ms"]) == {f"{c} {s}" for c in tdc.configs() for s in tdc.STEPS}
        assert all(np.isfinite(v) for v in got["fixed_ms"].values())
    assert rows and all(set(r) == row_keys | LAUNCHES for r in rows), rows
    assert not any(r[k] for r in rows for k in ("k1_launches_per_call", "k2_launches_per_call"))  # the twins


FAIL_AT = {"diag_cfg1": tdc, "bwd_bisect": tbb, "texture_micro": gather_rows, "pack_micro": gather_rows,
           "gather_micro": gather_rows, "ctx_gather": gather_rows}


@pytest.mark.parametrize("name", list(FAIL_AT))
def test_a_failing_row_is_recorded_and_fails_the_run(name, tmp_path, monkeypatch):
    tool, argv = RUNS[name]

    def boom(*args, **kw):
        raise MemoryError("out of memory")

    monkeypatch.setattr(FAIL_AT[name], "measure", boom)
    rc, got = _run(tool, argv, tmp_path)
    assert rc == 1
    errors = [r["error"] for r in got["results"] if "error" in r]
    assert errors and all("out of memory" in e for e in errors)


def test_no_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for tool in (tdc, tbb, ttq, ttm, tpm, tgm, tcg):
        assert tool.main([]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 7

