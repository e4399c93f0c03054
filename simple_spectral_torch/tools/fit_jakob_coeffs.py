"""Fit the Jakob & Hanika 2019 sigmoid-polynomial coefficient cube (PyTorch
port of ``tools/fit_jakob_coeffs.py``).

    python -m simple_spectral_torch.tools.fit_jakob_coeffs --out PATH [--res 64] [--device cpu] [--json PATH]

For every sRGB value on a (max component, scale, x, y) cube, the
parameterization of rgb2spec_fetch (reference
src/jakob-and-hanika-2019/rgb2spec.c:77-118), it finds coefficients (c0, c1,
c2) such that the reflectance S(lam) = 1/2 x / sqrt(x^2+1) + 1/2 with x = c0
lam^2 + c1 lam + c2 reproduces the target RGB under D65 and the CIE 1931
observer: batched Gauss-Newton with 3x3 solves, continuation across the
brightness slices from the brightest down, and four rounds per slice of
reseeding each texel from a better-fitting 4-neighbour, all in float64 on
the device (the card unless ``--device cpu``; no card: exit 1).

It writes the JAX tool's npz (``scale`` f32[res], the z nodes, and
``coeffs`` f32[3, res, res, res, 3] indexed [max comp, z, y, x, coeff] in nm
units, as rgb2spec_eval_precise evaluates them, rgb2spec.c:129-133) to
``--out``, which is required and may not lie in the shipped data folder: the
port renders from the shipped table (``spectra/upsample_jakob.py``
``load_jakob_tables``) unless a caller passes a fitted one to
``jakob_tables_from_arrays``.

The arithmetic is the JAX tool's, written out plainly: the model as its
source writes it, and the Jacobian as ``jax.vmap(jax.jacfwd(residual))``
computes it, forward-mode tangents along the three coefficients carried
through JAX's jvp rules in JAX's order, with the tangent axis after the
texel axis (:func:`jac`).  The fit is basin-sensitive: whether a texel
adopts a neighbour's solution turns on comparisons of rgb errors at the
rounding level, so a last-bit change in the arithmetic lands a few texels
in another local minimum.  A fitted table therefore holds against a
reference by :func:`misses`, not word for word, and the arithmetic must not
be reshaped: on the CPU, the tangent axis put first (another summation
order in the einsum's matrix product), fused multiply-adds in the model, or
the closed-form derivative each land a res-16 node in a basin worse by
6.4e-5, and a res-4 texel at an rgb error of 0.236 against the JAX tool's
6.8e-5.

``--json`` writes the card's name and power limit, the resolution, the
seconds of each component and in all, the max fit rgb error, the peak
device memory, the launches and the device's busy time per slice
(:func:`fit_launches`, after the fit) and the least time an H100 could
take for the fit's FP64 operations (:func:`fit_ops`).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from simple_spectral_torch import resolve_device

LAM_LO, LAM_HI = 380.0, 780.0
N_LAM = 81  # the integration grid: the observer's, 380..780 nm at 5 nm
N_GN = 32  # Gauss-Newton iterations per call
RESEED_ROUNDS = 4
DAMPING = 1e-10  # Levenberg damping for the saturated corners

# The yardstick of a fitted table against a reference (:func:`misses`).  The
# fit is basin-sensitive (module docstring): a few texels in a thousand land
# in another local minimum, most fitting as well, a rare one worse.
# Measured: the JAX tool re-run against its own shipped res-64 table, 0.022%
# of texels differ, no node fits worse by more than 1e-6, worst excess
# 7.4e-7; this port on the CPU against the shipped res-16 table, 0.32% (39
# texels), no node worse by more than 1e-6, worst excess 7.7e-15; against
# the JAX tool's res-8 run, 2.1% (32), one node (0.065%) worse by 3.05e-6.
# The card's f64 arithmetic strays further from XLA-CPU's (cuBLAS's
# summation order in the einsums), and its res-64 table has 786,432 texels
# in which to meet an outlier, hence its looser worst excess.
TEXELS_DIFFER_MAX = 0.05  # share of texels with any word changed
WORSE_BY = 1e-6  # a node "fits worse" by more than this
NODES_WORSE_MAX = 0.001  # share of such nodes
EXCESS_MAX_CPU = 1e-5  # the largest excess of one node's error, fitted on the CPU
EXCESS_MAX_CARD = 1e-4  # the same, fitted on the card
MAX_ERR_SLACK = 1e-6  # max error of the fit <= the reference's + this

# FP64 operations of the fit, counted on this module's arithmetic (a square
# root, division or negation counts 1), per texel: one model evaluation
# (:func:`model_rgb` and the residual) is 10 per wavelength, 3 x 81 x 2 for
# the contraction and 3 for the target; the Jacobian (:func:`jac`) is 11 per
# wavelength shared by the tangents, 9 per tangent and wavelength, and 9 x
# 81 x 2 for the contraction.
OPS_MODEL = N_LAM * 10 + 3 * N_LAM * 2 + 3
OPS_JAC = N_LAM * 11 + 3 * N_LAM * 9 + 9 * N_LAM * 2
# one Gauss-Newton iteration: the residual and its loss (5), the Jacobian,
# the normal equations (63 + 18), the 3x3 LU solve (40), three trial steps
# (6 + a model evaluation + 5 each) and the selection (10)
OPS_ITER = OPS_MODEL + 5 + OPS_JAC + 63 + 18 + 40 + 3 * (6 + OPS_MODEL + 5) + 10


def fit_ops(res: int) -> int:
    """FP64 operations of a fit at ``res``: 3 res slices of res^2 texels,
    each slice 1 + RESEED_ROUNDS Gauss-Newton calls of N_GN iterations and
    a final residual and error (the reseeds' selections left out)."""
    per_call = N_GN * OPS_ITER + OPS_MODEL + 6
    return 3 * res * res * res * (1 + RESEED_ROUNDS) * per_call


def smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def rgb_responses(device):
    """(cmf f64[3, K], lam_n f64[K]): the RGB response per wavelength bin,
    normalized so a unit reflectance integrates to rgb (1, 1, 1), and the
    wavelengths mapped to [0, 1].  Computed in numpy float64 exactly as the
    JAX tool (``tools/fit_jakob_coeffs.py:47-61``), then moved to
    ``device``."""
    from simple_spectral_torch.config import RenderConfig
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    host = build_color_tables(RenderConfig(mode="mallett", observer=1931), device="cpu").host
    lams = np.linspace(LAM_LO, LAM_HI, N_LAM)
    obs = np.stack([o.sample_linear(lams) for o in host["obs"]])  # [3, K]
    d65 = host["d65_rad"].sample_linear(lams)  # [K]
    m_xyz2rgb = host["matr_xyz_to_lrgb"]  # [3, 3]
    w_xyz = (obs * d65).sum(axis=1)
    white = m_xyz2rgb @ w_xyz
    cmf = np.einsum("ij,jk->ik", m_xyz2rgb, obs * d65[None, :]) / white[:, None]
    lam_n = (lams - LAM_LO) / (LAM_HI - LAM_LO)
    return (torch.as_tensor(cmf, dtype=torch.float64, device=device),
            torch.as_tensor(lam_n, dtype=torch.float64, device=device))


def model_rgb(c, cmf, lam_n):
    """c f64[..., 3] (normalized-wavelength coefficients) -> rgb f64[..., 3]."""
    x = (c[..., 0:1] * lam_n + c[..., 1:2]) * lam_n + c[..., 2:3]
    s = 0.5 * x / torch.sqrt(x * x + 1.0) + 0.5  # [..., K]
    return torch.einsum("ck,...k->...c", cmf, s)


def residual(c, target, cmf, lam_n):
    return model_rgb(c, cmf, lam_n) - target


def jac(c, cmf, lam_n):
    """d residual / d c, f64[N, 3 (rgb), 3 (coefficient)]: the three
    tangents of ``jax.jacfwd`` on an axis after the texels', each step by
    JAX's jvp rule (mul: t_a b + a t_b; sqrt: t (0.5 / ans); div: t_a / b +
    (-t_b a) (1 / (b b)))."""
    x = ((c[..., 0:1] * lam_n + c[..., 1:2]) * lam_n + c[..., 2:3])[:, None, :]  # [N, 1, K]
    x_t = torch.stack((lam_n * lam_n, lam_n, torch.ones_like(lam_n)))  # [3, K]
    u_t = x_t * x + x * x_t  # [N, 3, K]
    q = torch.sqrt(x * x + 1.0)
    q_t = u_t * (0.5 / q)
    p = 0.5 * x
    s_t = (0.5 * x_t) / q + (-q_t * p) * (1.0 / (q * q))
    return torch.einsum("ck,njk->ncj", cmf, s_t)


def gn_iterate(c0, target, cmf, lam_n, n_gn: int = N_GN):
    """``n_gn`` damped Gauss-Newton steps per texel, each the best of the
    full, half and quarter step if it lowers the loss -> (c f64[N, 3], the
    rgb error f64[N]).  Raises if a 3x3 solve failed."""
    eye = DAMPING * torch.eye(3, dtype=c0.dtype, device=c0.device)
    c = c0
    infos = []
    for _ in range(n_gn):
        r = residual(c, target, cmf, lam_n)
        J = jac(c, cmf, lam_n)
        jtj = torch.einsum("nij,nik->njk", J, J) + eye
        jtr = torch.einsum("nij,ni->nj", J, r)
        # solve_ex: torch.linalg.solve checks its result, a wait on the card per call
        step, info = torch.linalg.solve_ex(jtj, jtr[..., None])
        infos.append(info)
        step = step[..., 0]
        loss0 = (r * r).sum(-1)

        def try_scale(scale):
            cn = c - step * scale
            rn = residual(cn, target, cmf, lam_n)
            return cn, (rn * rn).sum(-1)

        c1, l1 = try_scale(1.0)
        c2, l2 = try_scale(0.5)
        c3, l3 = try_scale(0.25)
        best_c = torch.where((l1 <= l2)[:, None] & (l1 <= l3)[:, None], c1,
                             torch.where((l2 <= l3)[:, None], c2, c3))
        best_l = torch.minimum(torch.minimum(l1, l2), l3)
        c = torch.where((best_l < loss0)[:, None], best_c, c)
    bad = int((torch.stack(infos) != 0).sum())
    if bad:
        raise FloatingPointError(f"gn_iterate: {bad} of {n_gn * c.shape[0]} 3x3 solves failed")
    r = residual(c, target, cmf, lam_n)
    return c, torch.sqrt((r * r).sum(-1))


def reseed_from_neighbors(c, err, res: int):
    """Each texel of a res x res slice takes the solution of the 4-neighbour
    with the least error below its own, neighbours taken in the JAX tool's
    order with ``roll``, so the slice's edges wrap as there
    (``tools/fit_jakob_coeffs.py:105-119``)."""
    cg = c.reshape(res, res, 3)
    eg = err.reshape(res, res)
    best_c, best_e = cg, eg
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        nc = torch.roll(cg, shift, dims=axis)
        ne = torch.roll(eg, shift, dims=axis)
        take = ne < best_e
        best_c = torch.where(take[..., None], nc, best_c)
        best_e = torch.where(take, ne, best_e)
    return best_c.reshape(-1, 3)


def fit_slice(c_prev, target, res: int, cmf, lam_n, n_gn: int = N_GN):
    """One brightness slice from the previous slice's solution: a
    Gauss-Newton call, then RESEED_ROUNDS rounds of reseeding and another
    call, each texel keeping the better fit -> (c f64[res^2, 3], err)."""
    c_fit, err = gn_iterate(c_prev, target, cmf, lam_n, n_gn)
    for _ in range(RESEED_ROUNDS):
        c_new, err_new = gn_iterate(reseed_from_neighbors(c_fit, err, res), target, cmf, lam_n, n_gn)
        c_fit = torch.where((err_new < err)[:, None], c_new, c_fit)
        err = torch.minimum(err, err_new)
    return c_fit, err


def scale_nodes(res: int) -> np.ndarray:
    """The z nodes f64[res]; node 0 is 1e-4, not the degenerate black."""
    scale = smoothstep(smoothstep(np.linspace(0.0, 1.0, res)))
    scale[0] = 1e-4
    return scale


def slice_target(comp: int, z: float, res: int) -> np.ndarray:
    """The target rgb f64[res^2, 3] of slice z of component ``comp``: the
    component at z, the next two at x z and y z (x fastest)."""
    xy = np.linspace(0.0, 1.0, res)
    gx, gy = np.meshgrid(xy, xy, indexing="xy")
    target = np.zeros((res * res, 3))
    target[:, comp] = z
    target[:, (comp + 1) % 3] = (gx * z).reshape(-1)
    target[:, (comp + 2) % 3] = (gy * z).reshape(-1)
    return target


def to_nm(coeffs: np.ndarray) -> np.ndarray:
    """Normalized-wavelength coefficients f64[..., 3] -> nm units, f32
    (``tools/fit_jakob_coeffs.py:155-160``)."""
    a, b = LAM_LO, LAM_HI - LAM_LO
    cn0, cn1, cn2 = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    c0 = cn0 / b**2
    c1 = cn1 / b - 2 * a * cn0 / b**2
    c2 = cn0 * (a / b) ** 2 - cn1 * a / b + cn2
    return np.stack([c0, c1, c2], axis=-1).astype(np.float32)


class JakobFit(NamedTuple):
    scale: np.ndarray  # f32[res]
    coeffs: np.ndarray  # f32[3, res, res, res, 3], nm units
    max_err: float  # the largest rgb error of a node at the end of its fit (f64 coefficients)
    seconds: list  # per component, host clock to a synchronize


def fit(res: int = 64, device="cuda") -> JakobFit:
    """The coefficient cube at ``res`` nodes per axis, fitted on
    ``device`` in float64 (``tools/fit_jakob_coeffs.py:121-160``).  Prints
    the JAX tool's line per component."""
    dev = resolve_device(device)
    f64 = torch.float64
    cmf, lam_n = rgb_responses(dev)
    scale = scale_nodes(res)
    coeffs = torch.zeros((3, res, res * res, 3), dtype=f64, device=dev)
    max_err = torch.zeros((), dtype=f64, device=dev)
    seconds = []
    t0 = time.perf_counter()
    for comp in range(3):
        t_comp = time.perf_counter()
        # continuation: the brightest slice from zeros, then each darker one
        # from the previous solution
        c_prev = torch.zeros((res * res, 3), dtype=f64, device=dev)
        for zi in range(res - 1, -1, -1):
            target = torch.as_tensor(slice_target(comp, scale[zi], res), device=dev)
            c_prev, err = fit_slice(c_prev, target, res, cmf, lam_n)
            coeffs[comp, zi] = c_prev
            max_err = torch.maximum(max_err, err.max())
        err_so_far = float(max_err)  # waits for the device
        seconds.append(time.perf_counter() - t_comp)
        print(f"comp {comp} done ({time.perf_counter() - t0:.0f}s), max rgb err so far {err_so_far:.3e}", flush=True)
    out = to_nm(coeffs.reshape(3, res, res, res, 3).cpu().numpy())
    return JakobFit(scale.astype(np.float32), out, float(max_err), seconds)


def fit_launches(res: int, device="cuda"):
    """(kernel-launch calls of a whole fit at ``res``, the device's kernel
    ms of one slice) on the card, or (None, None) if the profiler saw no
    device activity.  It profiles the first slice at two and at three
    Gauss-Newton iterations per call: from the second on, every iteration
    launches the same kernels, so a slice at N_GN is the one at two plus
    N_GN - 2 times the difference, and every slice runs the same
    operations (profiling a whole slice costs seconds)."""
    from simple_spectral_torch.tools import profile_call

    dev = resolve_device(device)
    cmf, lam_n = rgb_responses(dev)
    target = torch.as_tensor(slice_target(0, scale_nodes(res)[-1], res), device=dev)
    c0 = torch.zeros((res * res, 3), dtype=torch.float64, device=dev)
    (l2, b2), (l3, b3) = (profile_call(lambda: fit_slice(c0, target, res, cmf, lam_n, n))[2:] for n in (2, 3))
    if not (b2 and b3):
        return None, None
    return (l2 + (N_GN - 2) * (l3 - l2)) * 3 * res, (b2 + (N_GN - 2) * (b3 - b2)) / 1e3


def node_errors(scale: np.ndarray, coeffs: np.ndarray, cmf: np.ndarray) -> np.ndarray:
    """The rgb round-trip error f64[3, res, res, res] of a stored table:
    each node's target rgb against ``cmf @ S(lam)`` of its f32 nm
    coefficients on the 81-point 380-780 nm grid, in float64."""
    res = scale.shape[0]
    lams = np.linspace(LAM_LO, LAM_HI, N_LAM)
    out = np.empty((3, res, res, res))
    for comp in range(3):
        for zi in range(res):
            c = coeffs[comp, zi].reshape(-1, 3).astype(np.float64)
            x = (c[:, 0:1] * lams + c[:, 1:2]) * lams + c[:, 2:3]
            s = 0.5 * x / np.sqrt(x * x + 1.0) + 0.5
            d = s @ cmf.T - slice_target(comp, float(scale[zi]), res)
            out[comp, zi] = np.sqrt((d * d).sum(-1)).reshape(res, res)
    return out


def compare_tables(a, b) -> dict:
    """A fitted table ``a`` against a reference ``b``, each (scale f32[res],
    coeffs f32[3, res, res, res, 3]): texels and words that differ, the
    largest absolute and relative coefficient difference, each table's max
    node error (:func:`node_errors`), the largest excess of a's node error
    over b's (``worst_excess``) and the nodes where a fits worse than b by
    more than WORSE_BY."""
    (sa, ca), (sb, cb) = a, b
    if ca.shape != cb.shape:
        raise ValueError(f"tables of shapes {ca.shape} and {cb.shape}")
    cmf = rgb_responses("cpu")[0].numpy()
    ea = node_errors(np.asarray(sa), ca, cmf)
    eb = node_errors(np.asarray(sb), cb, cmf)
    words = ca != cb
    diff = np.abs(ca.astype(np.float64) - cb.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(words, diff / np.abs(cb.astype(np.float64)), 0.0)
    excess = ea - eb
    return {
        "res": int(ca.shape[1]),
        "texels": int(ea.size),
        "scale_equal": bool(np.array_equal(sa, sb)),
        "texels_differ": int(words.any(axis=-1).sum()),
        "words_differ": int(words.sum()),
        "max_abs_diff": float(diff.max()),
        "max_rel_diff": float(rel.max()),
        "max_err_a": float(ea.max()),
        "max_err_b": float(eb.max()),
        "worst_excess": float(excess.max()),
        "nodes_worse": int((excess > WORSE_BY).sum()),
    }


def misses(cmp: dict, excess_max: float) -> list:
    """The yardstick's conditions that ``compare_tables``' result breaks
    (none: table a holds against b), with ``excess_max`` the bound of the
    worst excess (EXCESS_MAX_CPU or EXCESS_MAX_CARD, by where a was
    fitted)."""
    out = []
    if not cmp["scale_equal"]:
        out.append("the scale nodes differ")
    if cmp["texels_differ"] > TEXELS_DIFFER_MAX * cmp["texels"]:
        out.append(f"{cmp['texels_differ']} of {cmp['texels']} texels differ (> {TEXELS_DIFFER_MAX:.0%})")
    if cmp["nodes_worse"] > NODES_WORSE_MAX * cmp["texels"]:
        out.append(f"{cmp['nodes_worse']} nodes fit worse by > {WORSE_BY:g} (> {NODES_WORSE_MAX:.1%})")
    if cmp["worst_excess"] > excess_max:
        out.append(f"worst excess {cmp['worst_excess']:.3e} > {excess_max:g}")
    if cmp["max_err_a"] > cmp["max_err_b"] + MAX_ERR_SLACK:
        out.append(f"max error {cmp['max_err_a']:.4e} > the reference's {cmp['max_err_b']:.4e} + {MAX_ERR_SLACK:g}")
    return out


def main(argv=None) -> int:
    from simple_spectral_torch.spectra.spectrum import in_data_dir
    from simple_spectral_torch.tools import H100_FP64_OPS_PER_S, card_line, tool_device, write_json

    p = argparse.ArgumentParser(prog="fit_jakob_coeffs", description=__doc__.split("\n\n")[0])
    p.add_argument("--res", type=int, default=64, help="nodes per axis (default 64)")
    p.add_argument("--device", default="cuda", help="cuda (default); cpu to fit on the CPU")
    p.add_argument("--out", required=True, help="the npz to write (not in the shipped data folder)")
    p.add_argument("--json", default=None, help="where to write the run's figures")
    args = p.parse_args(argv)
    if in_data_dir(args.out):
        p.error(f"--out {args.out} lies in the shipped data folder, which the port never writes")
    dev = tool_device(args.device, "fit_jakob_coeffs")
    if dev is None:
        return 1
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    result = fit(args.res, dev)
    np.savez_compressed(args.out, scale=result.scale, coeffs=result.coeffs)
    print(f"wrote {args.out}; max fit rgb error {result.max_err:.3e}")
    if args.json:
        peak = torch.cuda.max_memory_allocated(dev) if card else None
        launches, busy_ms = fit_launches(args.res, dev) if card else (None, None)
        write_json(args.json, {
            "device": card_line() if card else "cpu", "res": args.res,
            "seconds_per_component": result.seconds, "seconds": sum(result.seconds), "max_fit_rgb_err": result.max_err,
            "launches": launches, "busy_ms_per_slice": busy_ms, "peak_bytes": peak,
            "fp64_bound_ms": fit_ops(args.res) / H100_FP64_OPS_PER_S * 1e3})
    return 0


if __name__ == "__main__":
    sys.exit(main())
