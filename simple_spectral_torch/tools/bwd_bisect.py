"""The train step's backward, split: the no-texture fwd+bwd step re-timed
with one spectral subgraph stubbed out per row (PyTorch port of
``tools/bench_bwd_bisect.py``).

    python -m simple_spectral_torch.tools.bwd_bisect [out.json] [--calls 10] [--size S] [--max-depth D]
        [--device cpu]

The JAX tool's call (``tools/bench_bwd_bisect.py:50-68``): cornell, mallett,
512x512 (spp 64 in the configuration, which no call reads);
``forward_backward_step`` at ``SPP = 4`` samples on ``lanes = min(w h,
max_lanes // 4, 262144)`` lanes (pixels ``arange(lanes)``), remat "none",
a zero target, call i on ``fold_in(fold_in(PRNGKey(0), i), 0)`` (the JAX
chain's key with its token of 0).  That is the JAX ``value_and_grad`` of
``_loss_fn(..., SPP, "none")`` over ``material_params``.  Its five rows:

1. "baseline no-texture fwd+bwd";
2. "XYZ estimator stubbed": ``render/integrator.py``'s
   ``specradflux_to_ciexyz_hero_soa`` replaced by :func:`fake_xyz`, the
   flux summed over the wavelengths, three times;
3. "precompute cache stubbed": its ``precompute_constant_spectra`` replaced
   by :func:`fake_precompute`, each material's mean albedo and emission
   value broadcast to [M, S, N] (the gradient still reaches
   ``albedo_values`` and ``emission_values`` through the means);
4. "both stubbed";
5. "baseline, remat_cache=False".

The stubs break the step's meaning, not its shapes, so row differences
attribute its cost.  They replace the integrator module's names, which
``trace_lanes`` looks up at every call, and the originals come back when the
row ends, also when it raises.  The JAX tool's ``fake_xyz`` takes no
``lambda_min``, which the JAX integrator passes, so its rows 2 and 4 raise
``TypeError`` on today's JAX package; the port's stub takes it.

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 10
between two synchronizes, host clock).  The file holds the JAX tool's
``{"device", "spp", "results"}`` (no ``rtt_s``: no round trip is
subtracted), each row ``label`` and ``ms_per_call`` with K1's and K2's
launches per call and the peak device memory, unrounded.  A row that
raises leaves ``error``, and the tool exits 1.  It runs on the card unless
``--device cpu`` is given, and exits 1 without one; ``--size`` and
``--max-depth`` cut it for the CPU check.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import integrator
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

N = 262144
SPP = 4
K_CALLS = 10
XYZ, PRECOMPUTE = "specradflux_to_ciexyz_hero_soa", "precompute_constant_spectra"


def fake_xyz(tables, flux, lam0, n_wavelengths, lambda_step, lambda_min=None):
    """The XYZ estimator's stub: the flux f32[S, N] summed over S, three
    times -> f32[3, N]."""
    s = torch.sum(flux, dim=0)
    return torch.stack([s, s, s])


def fake_precompute(scene, cfg, lam0):
    """The constant-spectra cache's stub: each material's mean albedo and
    emission value, broadcast to f32[M, S, N]; ``expand`` keeps the
    gradient path to the material tables."""
    m = scene.materials
    shape = (m.n_materials, cfg.n_wavelengths, lam0.shape[0])
    a = torch.mean(m.albedo_values, dim=1)[:, None, None]
    e = torch.mean(m.emission_values, dim=1)[:, None, None]
    return {"albedo": a.expand(shape), "emission": e.expand(shape)}


@dataclasses.dataclass(frozen=True)
class Row:
    label: str
    stubs: tuple = ()  # integrator names replaced: XYZ, PRECOMPUTE
    remat_cache: bool = True


ROWS = (
    Row("baseline no-texture fwd+bwd"),
    Row("XYZ estimator stubbed", (XYZ,)),
    Row("precompute cache stubbed", (PRECOMPUTE,)),
    Row("both stubbed", (XYZ, PRECOMPUTE)),
    Row("baseline, remat_cache=False", remat_cache=False),
)


def config() -> RenderConfig:
    return RenderConfig(scene="cornell", mode="mallett", width=512, height=512, spp=64)


def lanes_of(cfg: RenderConfig) -> int:
    return min(cfg.width * cfg.height, cfg.max_lanes // SPP, N)


@contextlib.contextmanager
def stubbed(names):
    """The integrator's ``names`` replaced by their stubs, restored after."""
    fakes = {XYZ: fake_xyz, PRECOMPUTE: fake_precompute}
    saved = {name: getattr(integrator, name) for name in names}
    try:
        for name in names:
            setattr(integrator, name, fakes[name])
        yield
    finally:
        for name, fn in saved.items():
            setattr(integrator, name, fn)


def step_fn(cfg: RenderConfig, dev):
    """Call i of a row: ``forward_backward_step`` on ``fold_in(fold_in(
    PRNGKey(0), i), 0)``, fresh tables and scene."""
    from simple_spectral_torch.render.trainstep import forward_backward_step
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    lanes = lanes_of(cfg)
    px = torch.arange(lanes, dtype=torch.int32, device=dev)
    target = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)
    key = rnd.PRNGKey(0)
    return lambda i: forward_backward_step(scene, tables, cfg, rnd.fold_in(rnd.fold_in(key, i), 0), px, target, SPP,
                                           "none")


def measure(row: Row, cfg: RenderConfig, k_calls: int, dev) -> dict:
    """One row: {"label", "ms_per_call", "k1_launches_per_call",
    "k2_launches_per_call", "peak_bytes"}."""
    cfg = cfg.replace(remat_cache=row.remat_cache)
    with stubbed(row.stubs):
        res = time_calls(step_fn(cfg, dev), k_calls, [dev])
    return {"label": row.label, "ms_per_call": res.pop("seconds_per_call") * 1e3, **res}


def main(argv=None) -> int:
    from simple_spectral_torch.bench import device_line

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    add_tool_args(p)
    p.add_argument("--calls", type=int, default=K_CALLS, help=f"timed calls per row (default {K_CALLS})")
    args = p.parse_args(argv)
    dev = tool_device(args.device, "bwd_bisect")
    if dev is None:
        return 1

    cfg = cut(config(), args)
    data = {"device": device_line(dev), "spp": SPP, "results": []}
    for row in ROWS:
        res, err = guarded(row.label, measure, row, cfg, args.calls, dev)
        data["results"].append(res or {"label": row.label, "error": err})
        if res:
            print(f"{row.label:32s} {res['ms_per_call']:10.3f} ms/call  K1 {res['k1_launches_per_call']} "
                  f"K2 {res['k2_launches_per_call']} per call, peak {res['peak_bytes']} bytes", flush=True)
        write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if any("error" in r for r in data["results"]) else 0


if __name__ == "__main__":
    sys.exit(main())
