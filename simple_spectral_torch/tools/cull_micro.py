"""Block cull (K2) against the dense sweep (K1) for one closest-hit sweep at
stress scale, coherent against random rays (PyTorch port of
``tools/bench_cull_micro.py``).

    python -m simple_spectral_torch.tools.cull_micro [out.json] [--boxes 1000,5000,10000] [--rays 262144]
        [--calls 12] [--size S] [--device cpu]

The JAX tool's configuration (``tools/bench_cull_micro.py:24-71``):
cornell-stress, rgb, RenderConfig's default 512x512, at each box count with
``stress_spheres = boxes // 20`` and ``intersect_impl="cull"`` (so the scene
has its cluster tiles); the host build's seconds go in ``build_host_s``.
Two ray sets of N = 262144 lanes:

* coherent: ``camera_rays_soa`` at ``PRNGKey(1)`` through the pixels
  ``arange(N) % (w * h)``, the real first sweep;
* random: numpy ``default_rng(0)``, origins uniform in (20, 530)^3 and
  normalized normal directions (:func:`volume_rays`, which the port's
  ``bvh_micro`` shares, with :func:`bench_impl`).

For each set, :func:`parity_check` first holds the cull route
(``intersect_rays_cull``, K2) against the dense route
(``intersect_rays_dispatch(impl="xla")``: K1's exact key and the sphere
merge) on the first 8192 rays with ignored primitives drawn from
``default_rng(99)``, with the JAX tool's comparator unchanged (equal hit
masks; distances within rtol 1e-5, atol 1e-3; more than 99.5% of winners on
the same primitive; equal materials and ``normal.x``, ``st_s``, ``st_t``
within 1e-4 on those lanes; no lane returning its ignored primitive).  It
raises on a difference, so that no number is published for a wrong
kernel: the set's timing is then skipped, the failure is recorded under
``parity_{set}_error`` and the tool exits 1.  Parity runs at every size.
Then :func:`bench_impl` times one whole sweep with attributes
(``need_attrs``) through each arm, ``cull`` and ``xla``, with
``tools.time_calls`` (2 warm-up calls, then K = 12 between two
synchronizes, host clock); the dense arm is not timed above 60000
triangles (triangles only, as the JAX tool counts them).

Each row keeps the JAX tool's ``boxes``, ``tris``, ``spheres``,
``clusters``, ``build_host_s``, ``parity_{coherent,random}`` (rays, hits,
lanes on another primitive, "ok") and ``{arm}_{set}_ms`` and
``{arm}_{set}_mrays_s``, and adds ``{arm}_{set}_k1_launches_per_call``,
``{arm}_{set}_k2_launches_per_call`` and ``{arm}_{set}_peak_bytes``; an arm
that raises leaves ``{arm}_{set}_error``, and the tool exits 1.  The file
holds ``device`` (the card's name and power limit), ``rays`` and
``results``, unrounded, and is rewritten after every row.  ``--rays`` below
8192 checks parity on every ray.  It runs on the card unless ``--device
cpu`` is given, and exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch.bench import device_line
from simple_spectral_torch.config import RenderConfig
from simple_spectral_torch.render import cull
from simple_spectral_torch.render import intersect
from simple_spectral_torch.render.vec import V3
from simple_spectral_torch.tools import add_tool_args, cut, guarded, time_calls, tool_device, write_json

N_RAYS = 262144
SIZES = (1000, 5000, 10000)  # stress boxes -> ~10k / 50k / 100k triangles
K_CALLS = 12
ARMS = ("cull", "xla")
SETS = ("coherent", "random")
# the JAX tool times no dense sweep above this many triangles
DENSE_MAX_TRIS = 60000
PARITY_RAYS, PARITY_SEED = 8192, 99
# the random rays' volume: the cornell box's interior
VOLUME_LO, VOLUME_HI = (20, 20, 20), (530, 530, 530)


def scene_config(boxes: int) -> RenderConfig:
    return RenderConfig(scene="cornell-stress", mode="rgb", stress_boxes=boxes, stress_spheres=boxes // 20,
                        intersect_impl="cull")


def arms(n_tris: int) -> list:
    """The arms timed on a scene of ``n_tris`` triangles."""
    return [a for a in ARMS if not (a == "xla" and n_tris > DENSE_MAX_TRIS)]


def volume_rays(n: int):
    """The JAX tools' random rays (numpy ``default_rng(0)``): f32[n, 3]
    origins uniform in the box's interior and unit directions."""
    rng = np.random.default_rng(0)
    o = rng.uniform(VOLUME_LO, VOLUME_HI, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def v3(a: np.ndarray, dev) -> V3:
    """An f32[n, 3] array as contiguous lanes on ``dev``."""
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(dev) for i in range(3)))


def make_rays(scene, cfg: RenderConfig, coherent: bool, n: int):
    """One ray set of ``n`` lanes on the scene's device: (o V3, d V3)."""
    from simple_spectral_torch.render.integrator import camera_rays_soa

    dev = scene.device
    if coherent:
        px = torch.arange(n, dtype=torch.int32, device=dev) % (cfg.width * cfg.height)
        o, d = camera_rays_soa(scene, cfg, rnd.PRNGKey(1), px % cfg.width, px // cfg.width)
        return V3(*(c.contiguous() for c in o)), d
    o, d = volume_rays(n)
    return v3(o, dev), v3(d, dev)


def parity_check(scene, eps: float, o: V3, d: V3, n_check: int = PARITY_RAYS, seed: int = PARITY_SEED) -> dict:
    """The cull route (K2) against the dense route (K1's exact key and the
    sphere merge) on the first ``n_check`` rays, with the JAX tool's
    comparator (``tools/bench_cull_micro.py:73-115``).  Raises on a
    difference; returns {"rays", "hits", "prim_tie_diffs", "parity"}."""
    rng = np.random.default_rng(seed)
    o_s, d_s = V3(*(c[:n_check] for c in o)), V3(*(c[:n_check] for c in d))
    ignore_np = rng.integers(-1, scene.n_prims, size=n_check).astype(np.int32)
    ignore = torch.from_numpy(ignore_np).to(scene.device)
    r_cull = cull.intersect_rays_cull(scene, o_s, d_s, ignore, eps)
    r_soa = intersect.intersect_rays_dispatch(scene, o_s, d_s, ignore, eps, impl="xla")

    def np_(t):
        return t.cpu().numpy()

    hit_c, hit_s = np_(r_cull.hit), np_(r_soa.hit)
    np.testing.assert_array_equal(hit_c, hit_s)
    m = hit_c
    np.testing.assert_allclose(np_(r_cull.dist)[m], np_(r_soa.dist)[m], rtol=1e-5, atol=1e-3)
    same = np_(r_cull.prim)[m] == np_(r_soa.prim)[m]
    assert same.mean() > 0.995, f"prim mismatch {(~same).sum()}/{m.sum()}"
    np.testing.assert_array_equal(np_(r_cull.mat)[m][same], np_(r_soa.mat)[m][same])
    for a, b in ((r_cull.normal.x, r_soa.normal.x), (r_cull.st_s, r_soa.st_s), (r_cull.st_t, r_soa.st_t)):
        np.testing.assert_allclose(np_(a)[m][same], np_(b)[m][same], rtol=1e-4, atol=1e-4)
    assert not np.any(np_(r_cull.prim)[m] == ignore_np[m])
    return {"rays": n_check, "hits": int(m.sum()), "prim_tie_diffs": int((~same).sum()), "parity": "ok"}


def hit_dist_sum(rec) -> torch.Tensor:
    """A sweep's checked output: the sum of its hit distances (the JAX
    tools' chained value, which is finite when every hit is)."""
    return torch.where(rec.hit, rec.dist, 0.0).sum()


def bench_impl(scene, eps: float, impl: str, o: V3, d: V3, k_calls: int) -> dict:
    """One arm's {"ms", "mrays_s", "k1_launches_per_call",
    "k2_launches_per_call", "peak_bytes"} over one closest-hit sweep of the
    rays with attributes: ``cull`` (K2), ``xla`` (K1's exact key and the
    sphere merge) or ``bvh`` (the BVH walk)."""
    n = o.x.shape[0]
    ignore = torch.full((n,), -1, dtype=torch.int32, device=scene.device)

    def step(i):
        return hit_dist_sum(intersect.intersect_rays_dispatch(scene, o, d, ignore, eps, impl=impl))

    res = time_calls(step, k_calls, [scene.device])
    dt = res.pop("seconds_per_call")
    return {"ms": dt * 1e3, "mrays_s": n / dt / 1e6, **res}


def measure_row(boxes: int, args, dev) -> tuple:
    """One box count's row; returns (row, failed)."""
    from simple_spectral_torch.scene.library import build_scene
    from simple_spectral_torch.spectra.colorimetry import build_color_tables

    cfg = cut(scene_config(boxes), args)
    tables = build_color_tables(cfg, device=dev)
    t0 = time.time()
    scene = build_scene(cfg, tables, device=dev)
    row = {"boxes": boxes, "tris": scene.n_tris, "spheres": scene.n_spheres,
           "clusters": int(scene.cull_tiles.shape[0]), "build_host_s": time.time() - t0}
    failed = False
    for tag in SETS:
        o, d = make_rays(scene, cfg, tag == "coherent", args.rays)
        par, err = guarded(f"boxes={boxes} parity[{tag}]", parity_check, scene, cfg.eps, o, d,
                           min(PARITY_RAYS, args.rays))
        if err:
            row[f"parity_{tag}_error"] = err
            failed = True
            continue
        row[f"parity_{tag}"] = par
        print(f"boxes={boxes} parity[{tag}]: {par}", flush=True)
        for arm in arms(scene.n_tris):
            res, err = guarded(f"boxes={boxes} {arm} {tag}", bench_impl, scene, cfg.eps, arm, o, d,
                               args.calls or K_CALLS)
            if err:
                row[f"{arm}_{tag}_error"] = err
                failed = True
                continue
            row.update({f"{arm}_{tag}_{k}": v for k, v in res.items()})
            print(f"boxes={boxes} {arm} {tag}: {res['ms']:.4f} ms ({res['mrays_s']:.2f} Mrays/s), K1 "
                  f"{res['k1_launches_per_call']} K2 {res['k2_launches_per_call']} per call", flush=True)
    return row, failed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default=None, help="JSON file to write")
    p.add_argument("--boxes", default=",".join(map(str, SIZES)), help="box counts, comma-separated")
    p.add_argument("--rays", type=int, default=N_RAYS, help=f"rays per sweep (default {N_RAYS})")
    add_tool_args(p, calls=True)
    args = p.parse_args(argv)
    dev = tool_device(args.device, "cull_micro")
    if dev is None:
        return 1

    data = {"device": device_line(dev), "rays": args.rays, "results": []}
    failed = False
    for boxes in (int(b) for b in args.boxes.split(",")):
        res, err = guarded(f"boxes={boxes}", measure_row, boxes, args, dev)
        row, row_failed = res if res else ({"boxes": boxes, "error": err}, True)
        failed |= row_failed
        data["results"].append(row)
        write_json(args.out, data)
    if args.out:
        print(f"wrote {args.out}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
