"""The pieces of ``texture_albedo_deferred`` timed alone at the render's
scale, 9 bounces x 262144 lanes (PyTorch port of
``tools/bench_texture_micro.py``).

    python -m simple_spectral_torch.tools.texture_micro [out.json] [--n 262144] [--calls 12] [--device cpu]

The JAX tool's inputs (``tools/bench_texture_micro.py:32-37``): cornell-srgb,
mallett, 512x512 (its texture has T = 262144 texels), ``tex_idx =
randint(PRNGKey(0), (9, N), 0, T)`` and ``lam0 = 380 + uniform(PRNGKey(0),
(N,)) * 395``, drawn by ``simple_spectral_torch.random``, bit-equal to
``jax.random``.  Its four rows (``:49-71``), each call summing one function
over the 9 bounces' index rows:

* "gather u32 only (9x)": the packed texel words at the indices, as f32;
* "gather+unpack+srgb_to_lrgb (9x)": ``texel_fetch_lrgb``, r + g + b;
* "texture_albedo_deferred mallett (9x)": the full deferred albedo, with
  ``cache["basis_hero"] = precompute_basis_hero(tables, cfg, lam0)``;
* "srgb_to_lrgb on [27, N]": the sRGB gamma alone on ``uniform(PRNGKey(0),
  (27, N))`` (plus the first index times 1e-30, as the JAX row adds).

Each row is timed by ``tools.time_calls`` (2 warm-up calls, then K = 12
between two synchronizes, host clock).  The JAX tool only prints; with a
path this writes ``{"device", "results"}``, each row ``label``, ``ms``,
K1's and K2's launches per call (0: no row sweeps) and the peak device
memory, unrounded.  A row that raises leaves ``error``, and the tool exits 1.
It runs on the card unless ``--device cpu`` is given, and exits 1 without
one; ``--n`` cuts the lanes for the CPU check.
"""

from __future__ import annotations

import sys

import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.tools.gather_rows import D, bounce_sum, main_for, take

N = 262144
K_CALLS = 12
LABELS = ("gather u32 only (9x)", "gather+unpack+srgb_to_lrgb (9x)", "texture_albedo_deferred mallett (9x)",
          "srgb_to_lrgb on [27, N]")


def config() -> RenderConfig:
    return RenderConfig(scene="cornell-srgb", mode="mallett", width=512, height=512, spp=64)


def draws(n: int, t: int, dev):
    """The JAX tool's draws, all from ``PRNGKey(0)``: (tex_idx i32[9, n] in
    [0, t), lam0 f32[n], the gamma row's input f32[27, n])."""
    key = rnd.PRNGKey(0)
    tex_idx = rnd.randint(key, (D, n), 0, t, device=dev)
    lam0 = 380.0 + rnd.uniform(key, (n,), dev) * 395.0
    rr = rnd.uniform(key, (3 * D, n), dev)
    return tex_idx, lam0, rr


def row_fns(scene, tables, cfg, lam0, rr) -> dict:
    """The four rows' per-bounce functions, by label: each maps one
    bounce's indices i32[n] to a scalar."""
    from simple_spectral_torch.render.shading import precompute_basis_hero, texel_fetch_lrgb, texture_albedo_deferred
    from simple_spectral_torch.spectra.colorimetry import srgb_to_lrgb

    cache = {"basis_hero": precompute_basis_hero(tables, cfg, lam0)}

    def fetch(ti):
        r, g, b = texel_fetch_lrgb(scene, ti)
        return (r + g + b).sum()

    return dict(zip(LABELS, (
        lambda ti: take(scene.texture, ti).to(torch.float32).sum(),
        fetch,
        lambda ti: texture_albedo_deferred(scene, tables, cfg, cache, ti, lam0).sum(),
        lambda ti: srgb_to_lrgb(rr + ti[0].to(torch.float32) * 1e-30).sum(),
    )))


def make_rows(n: int, dev) -> list:
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = config()
    tables = build_color_tables(cfg, device=dev)
    scene = build_scene(cfg, tables, device=dev)
    tex_idx, lam0, rr = draws(n, scene.texture.shape[0], dev)
    return [(label, lambda fn=fn: bounce_sum(fn, tex_idx), None)
            for label, fn in row_fns(scene, tables, cfg, lam0, rr).items()]


def main(argv=None) -> int:
    return main_for("texture_micro", __doc__, N, K_CALLS, make_rows, lambda args: {}, argv)


if __name__ == "__main__":
    sys.exit(main())
