"""The port's Jakob-Hanika coefficient fit and ``.coeff`` export
(``simple_spectral_torch/tools/fit_jakob_coeffs.py``,
``export_jakob_coeff.py``) against the JAX tools they replace
(``tools/fit_jakob_coeffs.py``, ``tools/export_jakob_coeff.py``), on the CPU.

* The RGB responses equal a numpy recomputation from the JAX package's
  colour tables, bit for bit.
* The fit at res 16 holds against the shipped ``jakob2019-srgb-16.npz``, the
  JAX tool's output word for word, and at res 8 and 4 against the JAX tool
  run in a subprocess (it reads ``sys.argv`` and switches JAX to float64 at
  import, so it never runs in this process), each under the yardstick
  ``fit_jakob_coeffs.misses`` with the CPU's bound of the worst excess; word
  equality cannot hold (the fit is basin-sensitive, see the module).  A
  table with a wrong unit conversion or no fit fails the yardstick.
* The Jacobian equals ``torch.func``'s forward-mode Jacobian of the
  residual within 1e-12 relative; the reseed equals the JAX tool's
  ``jnp.roll`` code, written in numpy, edges wrapping.
* The export's bytes equal the JAX export's; neither port tool writes into
  the shipped data folder; ``main`` writes its npz and JSON at res 2 and
  exits 1 for the card without one; the fitted arrays become the tables
  ``load_jakob_tables`` returns.

Each resolution is fitted once (module fixtures): res 16 takes about 20 s,
res 8 about 5 s and res 4 about 2 s on the CPU, and the JAX tool's res 8 and
4 a few seconds in one subprocess.  No JAX function is compiled in this
process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from simple_spectral_torch.spectra.spectrum import DATA_DIR, data_path
from simple_spectral_torch.spectra.upsample_jakob import jakob_tables_from_arrays, load_jakob_tables
from simple_spectral_torch.tools import export_jakob_coeff as export_port
from simple_spectral_torch.tools import fit_jakob_coeffs as fj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shipped(res: int):
    with np.load(data_path(f"jakob2019-srgb-{res}.npz")) as z:
        return z["scale"], z["coeffs"]


@pytest.fixture(scope="module")
def fit16():
    return fj.fit(16, "cpu")


@pytest.fixture(scope="module")
def fit8():
    return fj.fit(8, "cpu")


@pytest.fixture(scope="module")
def jax_tables(tmp_path_factory):
    """The JAX tool's tables at res 8 and 4, {res: (scale, coeffs)}, from one
    subprocess that loads the tool once per resolution with its
    ``data_path`` pointed at a temporary folder."""
    out_dir = str(tmp_path_factory.mktemp("jax_fit"))
    tool = os.path.join(REPO, "tools", "fit_jakob_coeffs.py")
    code = (
        "import importlib.util, os, sys\n"
        "for res in ('8', '4'):\n"
        "    sys.argv = ['fit_jakob_coeffs.py', res]\n"
        f"    spec = importlib.util.spec_from_file_location('jax_fit_jakob', {tool!r})\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        f"    m.data_path = lambda *p: os.path.join({out_dir!r}, *p)\n"
        "    m.main()\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tables = {}
    for res in (8, 4):
        with np.load(os.path.join(out_dir, f"jakob2019-srgb-{res}.npz")) as z:
            tables[res] = z["scale"], z["coeffs"]
    return tables


def test_rgb_responses_are_the_jax_tools():
    from simple_spectral_tpu.config import RenderConfig
    from simple_spectral_tpu.spectra.colorimetry import build_color_tables

    host = build_color_tables(RenderConfig(mode="mallett", observer=1931)).host
    lams = np.linspace(380.0, 780.0, 81)
    obs = np.stack([o.sample_linear(lams) for o in host["obs"]])
    d65 = host["d65_rad"].sample_linear(lams)
    m = host["matr_xyz_to_lrgb"]
    cmf = np.einsum("ij,jk->ik", m, obs * d65[None, :]) / (m @ (obs * d65).sum(axis=1))[:, None]
    cmf_t, lam_t = fj.rgb_responses("cpu")
    assert cmf_t.dtype == lam_t.dtype == torch.float64
    np.testing.assert_array_equal(cmf_t.numpy(), cmf)
    np.testing.assert_array_equal(lam_t.numpy(), (lams - 380.0) / 400.0)


def test_fit_res16_holds_against_the_shipped_table(fit16):
    ref = shipped(16)
    np.testing.assert_array_equal(fit16.scale, ref[0])
    assert fit16.coeffs.dtype == np.float32 and fit16.coeffs.shape == ref[1].shape
    cmp = fj.compare_tables((fit16.scale, fit16.coeffs), ref)
    # measured on this CPU: 39 of 12288 texels differ, no node fits worse by
    # more than 1e-6, worst excess 7.7e-15, max error 1.8904e-4 against the
    # shipped 3.7579e-4
    assert fj.misses(cmp, fj.EXCESS_MAX_CPU) == [], cmp
    assert abs(fit16.max_err - cmp["max_err_a"]) < 1e-6  # the fit's f64 error against its f32 table's


def test_fit_res8_holds_against_the_jax_tool(fit8, jax_tables):
    ref = jax_tables[8]
    np.testing.assert_array_equal(fit8.scale, ref[0])
    cmp = fj.compare_tables((fit8.scale, fit8.coeffs), ref)
    # measured: 32 of 1536 texels differ, one node (0.065%) worse by
    # 3.05e-6, max errors equal (1.3106e-4)
    assert fj.misses(cmp, fj.EXCESS_MAX_CPU) == [], cmp


def test_fit_res4_holds_against_the_jax_tool(jax_tables):
    ref = jax_tables[4]
    got = fj.fit(4, "cpu")
    np.testing.assert_array_equal(got.scale, ref[0])
    cmp = fj.compare_tables((got.scale, got.coeffs), ref)
    # measured: 7 of 192 texels differ, one node worse by 2.76e-6, max
    # errors equal (6.8211e-5); a single node is already 0.52% of 192, so
    # the share of nodes worse is bounded by the count measured instead.
    # A texel in the basin of the closed-form Jacobian fits at 0.236 here.
    assert cmp["nodes_worse"] <= 1, cmp
    assert [m for m in fj.misses(cmp, fj.EXCESS_MAX_CPU) if "nodes fit worse" not in m] == [], cmp


def test_the_yardstick_fails_a_broken_table():
    scale, coeffs = shipped(16)
    cmp = fj.compare_tables((scale, coeffs), (scale, coeffs))
    assert cmp["texels_differ"] == cmp["nodes_worse"] == 0 and cmp["worst_excess"] == 0.0
    assert fj.misses(cmp, fj.EXCESS_MAX_CPU) == []
    # the coefficients left in normalized-wavelength units, and no fit at all
    normalized = np.stack([coeffs[..., 0] * 400.0**2, coeffs[..., 1] * 400.0 + 2 * 380.0 * coeffs[..., 0] * 400.0,
                           coeffs[..., 2]], axis=-1).astype(np.float32)
    for bad in (normalized, np.zeros_like(coeffs)):
        missed = fj.misses(fj.compare_tables((scale, bad), (scale, coeffs)), fj.EXCESS_MAX_CARD)
        assert len(missed) >= 3, missed


def test_jac_is_forward_mode_jacobian():
    rng = np.random.default_rng(13)
    c = torch.as_tensor(rng.normal(size=(257, 3)) * np.array([30.0, 30.0, 5.0]))
    target = torch.as_tensor(rng.random((257, 3)))
    cmf, lam_n = fj.rgb_responses("cpu")
    want = torch.func.vmap(torch.func.jacfwd(lambda cc, tt: fj.residual(cc, tt, cmf, lam_n)))(c, target)
    got = fj.jac(c, cmf, lam_n)
    assert got.shape == (257, 3, 3)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-12


def test_gn_iterate_raises_on_a_failed_solve(monkeypatch):
    cmf, lam_n = fj.rgb_responses("cpu")
    c = torch.zeros((4, 3), dtype=torch.float64)
    target = torch.full((4, 3), 0.5, dtype=torch.float64)
    solve_ex = torch.linalg.solve_ex

    def failing(a, b):
        x, info = solve_ex(a, b)
        return x, torch.where(torch.arange(info.shape[0]) == 2, 1, info)

    monkeypatch.setattr(torch.linalg, "solve_ex", failing)
    with pytest.raises(FloatingPointError, match="2 of 8 3x3 solves failed"):
        fj.gn_iterate(c, target, cmf, lam_n, n_gn=2)


def reseed_numpy(c, err, res):
    """tools/fit_jakob_coeffs.py:105-119 with np.roll for jnp.roll."""
    cg = c.reshape(res, res, 3)
    eg = err.reshape(res, res)
    best_c, best_e = cg, eg
    for shift, axis in (((1,), 0), ((-1,), 0), ((1,), 1), ((-1,), 1)):
        nc = np.roll(cg, shift, axis=axis)
        ne = np.roll(eg, shift, axis=axis)
        take = ne < best_e
        best_c = np.where(take[..., None], nc, best_c)
        best_e = np.where(take, ne, best_e)
    return best_c.reshape(-1, 3)


def test_reseed_is_the_jax_tools_roll():
    res = 5
    c = np.arange(res * res * 3, dtype=np.float64).reshape(-1, 3)
    err = np.full((res, res), 1.0)
    err[0, 0] = 0.9
    err[res - 1, 0] = 0.1  # (0, 0)'s neighbour across the y edge: taken by wrapping
    err[2, 2] = 0.5
    err[1, 2] = 0.3  # (2, 2)'s neighbour, not taken: err[3, 2] = 1.0 is no better
    err[3, 2] = 0.3  # a tie with (1, 2) seen from (2, 2): the first shift's wins
    err[1, res - 1] = 0.2  # (1, 0)'s neighbour across the x edge
    err = err.reshape(-1)
    got = fj.reseed_from_neighbors(torch.as_tensor(c), torch.as_tensor(err), res).numpy()
    np.testing.assert_array_equal(got, reseed_numpy(c, err, res))
    np.testing.assert_array_equal(got[0], c[(res - 1) * res])  # wrapped in y
    np.testing.assert_array_equal(got[1 * res], c[1 * res + res - 1])  # wrapped in x
    np.testing.assert_array_equal(got[2 * res + 2], c[1 * res + 2])  # the tie: roll by +1 in y first
    np.testing.assert_array_equal(got[3], c[3])  # neighbours only as good: kept


def test_export_bytes_are_the_jax_exports(tmp_path):
    from tools.export_jakob_coeff import export as export_jax

    want = export_jax(16, str(tmp_path / "jax.coeff"))
    got = export_port.export(data_path("jakob2019-srgb-16.npz"), str(tmp_path / "port.coeff"))
    with open(want, "rb") as f:
        want_bytes = f.read()
    with open(got, "rb") as f:
        got_bytes = f.read()
    assert got_bytes == want_bytes
    assert got_bytes[:4] == b"SPEC" and len(got_bytes) == 8 + 4 * 16 + 4 * 3 * 16**3 * 3


def test_no_tool_writes_the_data_folder(tmp_path, capsys):
    before = sorted(os.listdir(DATA_DIR))
    dst = os.path.join(DATA_DIR, "jakob-and-hanika-2019-srgb-16.coeff")
    with pytest.raises(ValueError, match="shipped data folder"):
        export_port.export(data_path("jakob2019-srgb-16.npz"), dst)
    assert export_port.main([data_path("jakob2019-srgb-16.npz"), dst]) == 1
    with pytest.raises(SystemExit) as e:
        fj.main(["--res", "2", "--device", "cpu", "--out", data_path("jakob2019-srgb-2.npz")])
    assert e.value.code == 2
    assert sorted(os.listdir(DATA_DIR)) == before


def test_main_writes_the_table_and_its_json(tmp_path, capsys):
    out, js = tmp_path / "j.npz", tmp_path / "j.json"
    assert fj.main(["--res", "2", "--device", "cpu", "--out", str(out), "--json", str(js)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("comp ") == 3 and f"wrote {out}; max fit rgb error" in printed
    with np.load(out) as z:
        assert set(z.files) == {"scale", "coeffs"}
        assert z["scale"].dtype == z["coeffs"].dtype == np.float32
        assert z["scale"].shape == (2,) and z["coeffs"].shape == (3, 2, 2, 2, 3)
        assert np.isfinite(z["coeffs"]).all()
    with open(js) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and rec["res"] == 2 and len(rec["seconds_per_component"]) == 3
    assert rec["max_fit_rgb_err"] >= 0.0 and rec["launches"] is None and rec["peak_bytes"] is None
    assert set(rec) == {"device", "res", "seconds_per_component", "seconds", "max_fit_rgb_err", "launches",
                        "busy_ms_per_slice", "peak_bytes", "fp64_bound_ms"}


def test_main_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fj.main(["--out", str(tmp_path / "j.npz")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "j.npz").exists()


def test_fitted_arrays_make_the_shipped_tables():
    scale, coeffs = shipped(16)
    got = jakob_tables_from_arrays(scale, coeffs)
    want = load_jakob_tables(res=16)
    assert got["res"] == want["res"] == 16
    for k in ("scale", "coeffs"):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
