"""The port's spectra and colorimetry against the JAX package, on the CPU.

Host-built tables are float64 numpy on both sides before the same cast to
float32, so they must agree exactly; f32 lane math (sums in another order,
torch's and XLA's own pow) agrees to rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.spectra import colorimetry as tcol
from simple_spectral_torch.spectra import spectrum as tspec
from simple_spectral_torch.spectra.upsample_mallett import lrgb_to_specrefl_mallett as t_mallett
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.spectra import colorimetry as jcol
from simple_spectral_tpu.spectra import spectrum as jspec
from simple_spectral_tpu.spectra.upsample_mallett import lrgb_to_specrefl_mallett as j_mallett

RTOL = 1e-6
CONFIGS = [("rgb", 1931), ("mallett", 1931), ("mallett", 2006)]


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda p: f"{p[0]}-{p[1]}")
def tables(request):
    mode, observer = request.param
    cfg = RenderConfig(mode=mode, observer=observer)
    tcfg = TorchConfig(mode=mode, observer=observer)
    return cfg, jcol.build_color_tables(cfg), tcol.build_color_tables(tcfg, device="cpu")


def test_color_tables_leaves_exact(tables):
    _, jt, tt = tables
    for f in dataclasses.fields(tt):
        if f.name == "host":
            continue
        want, got = getattr(jt, f.name), getattr(tt, f.name)
        if want is None:
            assert got is None, f.name
        elif isinstance(got, torch.Tensor):
            assert got.dtype == torch.float32, f.name
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f.name)
        else:
            assert got == want, f.name
    for name in ("d65_rad_xyz", "matr_lrgb_to_xyz", "matr_xyz_to_lrgb"):
        np.testing.assert_array_equal(tt.host[name], jt.host[name])


def _flux_and_lam0(cfg, n, seed):
    rng = np.random.default_rng(seed)
    flux = rng.uniform(0.0, 50.0, size=(cfg.n_wavelengths, n)).astype(np.float32)
    lam0 = (cfg.lambda_min + rng.uniform(0.0, 1.0, size=n) * cfg.lambda_step).astype(np.float32)
    return flux, lam0


@pytest.mark.parametrize("shifted", [True, False], ids=["shifted-window", "general"])
def test_hero_xyz_estimator(tables, shifted):
    cfg, jt, tt = tables
    flux, lam0 = _flux_and_lam0(cfg, 1031, seed=3)
    lmin = cfg.lambda_min if shifted else None
    want = jcol.specradflux_to_ciexyz_hero_soa(jt, jnp.asarray(flux), jnp.asarray(lam0), cfg.n_wavelengths,
                                               cfg.lambda_step, lambda_min=lmin)
    got = tcol.specradflux_to_ciexyz_hero_soa(tt, torch.from_numpy(flux), torch.from_numpy(lam0),
                                              cfg.n_wavelengths, cfg.lambda_step, lambda_min=lmin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)


def test_srgb_conversions(tables):
    cfg, jt, tt = tables
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.1, 1.2, 4000), [0.0, 0.0031308, 0.04045, 1.0]]).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tcol.lrgb_to_srgb(tx).numpy(), np.asarray(jcol.lrgb_to_srgb(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(tcol.srgb_to_lrgb(tx).numpy(), np.asarray(jcol.srgb_to_lrgb(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(tcol.srgb_to_lrgb_np(x), jcol.srgb_to_lrgb_np(x))
    np.testing.assert_array_equal(tcol.lrgb_to_srgb_np(x), jcol.lrgb_to_srgb_np(x))
    xyz = rng.uniform(0.0, 2.0, size=(17, 5, 3)).astype(np.float32)
    want = jcol.ciexyz_to_srgb(jt, jnp.asarray(xyz), cfg.mode)
    got = tcol.ciexyz_to_srgb(tt, torch.from_numpy(xyz), cfg.mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


def test_spectrum_sampling_and_hat_weights():
    rng = np.random.default_rng(1)
    values = rng.uniform(0.0, 1.0, 81).astype(np.float32)
    lam = rng.uniform(360.0, 800.0, size=(4, 300)).astype(np.float32)
    want = jspec.sample_linear(jnp.asarray(values), 380.0, 0.2, jnp.asarray(lam))
    got = tspec.sample_linear(torch.from_numpy(values), 380.0, 0.2, torch.from_numpy(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)
    x = rng.uniform(-2.0, 30.0, size=(3, 50)).astype(np.float32)
    np.testing.assert_array_equal(tspec.hat_weights(torch.from_numpy(x), 28).numpy(),
                                  np.asarray(jspec.hat_weights(jnp.asarray(x), 28)))
    lam0 = rng.uniform(380.0, 480.0, 64).astype(np.float32)
    np.testing.assert_array_equal(tspec.hero_lams_soa(torch.from_numpy(lam0), 4, 100.0).numpy(),
                                  np.asarray(jspec.hero_lams_soa(jnp.asarray(lam0), 4, 100.0)))
    # host spectra: load, sample, integrate (float64, exact)
    cols_t, cols_j = tspec.load_spectral_csv("d65-300+5+780.csv"), jspec.load_spectral_csv("d65-300+5+780.csv")
    np.testing.assert_array_equal(cols_t[0], cols_j[0])
    st, sj = tspec.Spectrum(cols_t[0], 300.0, 780.0), jspec.Spectrum(cols_j[0], 300.0, 780.0)
    grid = np.linspace(290.0, 790.0, 777)
    np.testing.assert_array_equal(st.sample_linear(grid), sj.sample_linear(grid))
    assert st.integrate() == sj.integrate()
    tt, tj = st.to_table(), sj.to_table()
    assert (tt.low, tt.inv_step) == (tj.low, tj.inv_step)
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(tj.values))
    np.testing.assert_allclose(tspec.sample_linear(tt.values, tt.low, tt.inv_step, torch.from_numpy(lam)).numpy(),
                               np.asarray(jspec.sample_linear(tj.values, tj.low, tj.inv_step, jnp.asarray(lam))),
                               rtol=RTOL, atol=1e-5)
    assert tspec.Spectrum.integrate_product(st, st * 0.5) == jspec.Spectrum.integrate_product(sj, sj * 0.5)


def test_mallett_upsample():
    cfg = RenderConfig(mode="mallett")
    jt = jcol.build_color_tables(cfg)
    tt = tcol.build_color_tables(TorchConfig(mode="mallett"), device="cpu")
    rng = np.random.default_rng(2)
    lrgb = rng.uniform(0.0, 1.0, size=(257, 3)).astype(np.float32)
    lam0 = rng.uniform(380.0, 480.0, 257).astype(np.float32)
    want = j_mallett(jt, jnp.asarray(lrgb), jnp.asarray(lam0), 4, cfg.lambda_step)
    got = t_mallett(tt, torch.from_numpy(lrgb), torch.from_numpy(lam0), 4, cfg.lambda_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


def test_unported_modes_raise():
    """The meng and jakob modes, which once raised "not ported yet": their
    tables now load, equal to the JAX package's, and move with ``to``
    keeping their Python ints and floats."""
    for mode, key, other in (("meng", "meng", "jakob"), ("jakob", "jakob", "meng")):
        jt = jcol.build_color_tables(RenderConfig(mode=mode, observer=2006))
        tt = tcol.build_color_tables(TorchConfig(mode=mode, observer=2006), device="cpu")
        assert getattr(tt, other) is None and tt.basis_values is None
        want, got = getattr(jt, key), getattr(tt.to("cpu"), key)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, (int, float)):
                assert got[k] == v and type(got[k]) is type(v), k
            else:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(tt.obs_values.numpy(), np.asarray(jt.obs_values))
