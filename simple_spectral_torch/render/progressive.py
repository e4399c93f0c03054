"""Progressive rendering with checkpoint and resume (PyTorch port of
``simple_spectral_tpu.render.progressive``).

A render is a sequence of *passes*, a few spp each across the whole image,
whose per-pixel value sums accumulate in float64 on the host; every K passes
the accumulator checkpoints, so a long render restarts where it stopped.
Sample keys derive from (seed, samples done, chunk) exactly as in the JAX
package, so a resumed render gives bitwise the estimate of an uninterrupted
one, and the two packages draw the same sample streams.  With a mesh
(``parallel/sharding.py``) each chunk of a pass renders through
``sharded_sample_sums`` on the (dp, sp) shards, as the JAX package's
``_sharded_chunk`` does.

Two accumulation backends, with bitwise equal means:

* the native C++ runtime (``native/framebuffer.cpp`` through
  ``utils/native_fb.py``): f64 accumulator, asynchronous checkpoint writer
  (a binary file and a JSON sidecar with the config fingerprint);
* numpy, with a synchronous ``.npz`` checkpoint written through a
  ``.tmp.npz`` file and ``os.replace``.

Checkpoints are backend-specific, and each backend's format is the JAX
package's: a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from simple_spectral_torch import random as rnd
from simple_spectral_torch import resolve_device
from simple_spectral_torch.config import MODE_MENG, RenderConfig
from simple_spectral_torch.parallel.sharding import _pad_to, sharded_sample_sums
from simple_spectral_torch.render.renderer import _render_chunk, finalize_srgb
from simple_spectral_torch.utils.metrics import RenderMetrics
from simple_spectral_torch.utils.profiling import span

_CKPT_VERSION = 1


def _cfg_fingerprint(cfg: RenderConfig, mesh=None) -> str:
    """The configuration as the JAX package fingerprints it: every field,
    sorted, as JSON.  ``spp`` is a field, so a checkpoint refuses a
    configuration with another sample target; on a mesh the mesh's shape is
    one too, since the sample streams derive from the (dp, sp) shard
    indices and resume is bitwise only on the same factorization."""
    d = dataclasses.asdict(cfg)
    if mesh is not None:
        d["_mesh"] = dict(mesh.shape)
    return json.dumps(d, sort_keys=True)


class ProgressiveRenderer:
    """Accumulates render passes; checkpointable.

    Usage::

        pr = ProgressiveRenderer(cfg, checkpoint_path="render.ckpt")
        pr.resume()                # no-op if no checkpoint exists
        pr.run()                   # renders the remaining passes, checkpoints
        fb = pr.image()            # sRGB+A f32[H, W, 4]

    Tables and scene are built on ``device`` (the card by default) when not
    given.  ``native=None`` takes the native accumulator when it builds and
    numpy otherwise; ``True`` requires it, ``False`` takes numpy.  With a
    ``mesh`` (``parallel.make_mesh``) every pass renders on the (dp, sp)
    mesh; the pass size must then divide by sp.
    """

    def __init__(
        self,
        cfg: RenderConfig,
        scene=None,
        tables=None,
        seed: int = 0,
        checkpoint_path: Optional[str] = None,
        spp_per_pass: int = 4,
        native: Optional[bool] = None,
        mesh=None,
        device="cuda",
    ):
        from simple_spectral_torch.scene.library import build_scene
        from simple_spectral_torch.spectra.colorimetry import build_color_tables

        if tables is None or scene is None:
            device = resolve_device(device)
        self.cfg = cfg
        self.tables = tables if tables is not None else build_color_tables(cfg, device=device)
        self.scene = scene if scene is not None else build_scene(cfg, self.tables, device=device)
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.spp_per_pass = max(1, min(spp_per_pass, cfg.spp))
        self.mesh = mesh
        if mesh is not None and self.spp_per_pass % mesh.shape["sp"]:
            raise ValueError(f"spp_per_pass {self.spp_per_pass} must divide by the sp mesh axis {mesh.shape['sp']}")
        self.metrics = RenderMetrics(cfg)

        self._fb = None
        if native is not False:
            try:
                from simple_spectral_torch.utils.native_fb import NativeFramebuffer

                self._fb = NativeFramebuffer(cfg.width, cfg.height)
            except (RuntimeError, OSError):
                if native is True:
                    raise
        if self._fb is None:
            n_px = cfg.width * cfg.height
            self._sum_value = np.zeros((n_px, 3), np.float64)
            self._sum_alpha = np.zeros((n_px,), np.float64)
            self._spp_done = 0

    @property
    def native(self) -> bool:
        return self._fb is not None

    @property
    def spp_done(self) -> int:
        return self._fb.spp_done if self._fb is not None else self._spp_done

    # --- checkpointing ---

    def _sidecar(self, path: str) -> str:
        return path + ".meta.json"

    def save_checkpoint(self, path: Optional[str] = None, wait: bool = True) -> str:
        path = path or self.checkpoint_path
        if not path:
            raise ValueError("no checkpoint path configured")
        if self._fb is not None:
            with open(self._sidecar(path), "w") as f:
                json.dump({"version": _CKPT_VERSION, "cfg": _cfg_fingerprint(self.cfg, self.mesh),
                           "seed": self.seed}, f)
            self._fb.checkpoint_async(path)
            if wait and not self._fb.checkpoint_wait():
                raise OSError(f"cannot write native checkpoint {path}")
            return path
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            version=_CKPT_VERSION,
            cfg=_cfg_fingerprint(self.cfg, self.mesh),
            seed=self.seed,
            spp_done=self._spp_done,
            sum_value=self._sum_value,
            sum_alpha=self._sum_alpha,
        )
        os.replace(tmp, path)
        return path

    def _check_meta(self, version, cfg: str, seed) -> None:
        if int(version) != _CKPT_VERSION:
            raise ValueError(f"checkpoint version {version} != {_CKPT_VERSION}")
        if cfg != _cfg_fingerprint(self.cfg, self.mesh):
            raise ValueError("checkpoint was produced by a different RenderConfig")
        if int(seed) != self.seed:
            raise ValueError("checkpoint seed differs")

    def resume(self, path: Optional[str] = None) -> bool:
        """Load state from a checkpoint; returns True if one was loaded."""
        path = path or self.checkpoint_path
        if not path or not os.path.exists(path):
            return False
        if self._fb is not None:
            with open(self._sidecar(path)) as f:
                meta = json.load(f)
            self._check_meta(meta["version"], meta["cfg"], meta["seed"])
            if not self._fb.checkpoint_load(path):
                raise ValueError(f"cannot load native checkpoint {path}")
            return True
        with np.load(path, allow_pickle=False) as z:
            self._check_meta(z["version"], str(z["cfg"]), z["seed"])
            self._sum_value = np.asarray(z["sum_value"])
            self._sum_alpha = np.asarray(z["sum_alpha"])
            self._spp_done = int(z["spp_done"])
        return True

    # --- rendering ---

    def run_pass(self, pass_spp: Optional[int] = None) -> int:
        """Render one pass of ``pass_spp`` samples per pixel; returns the new
        spp_done.

        Pixels are chunked by ``cfg.max_lanes`` (not by
        ``render_chunk_lanes``, as in the JAX package; on a mesh rounded down
        to a multiple of dp), and the chunk index feeds the key, so the
        chunking is part of the sample stream."""
        cfg = self.cfg
        pass_spp = pass_spp or min(self.spp_per_pass, cfg.spp - self.spp_done)
        if pass_spp <= 0:
            raise ValueError(f"no samples left to render ({self.spp_done} of {cfg.spp} done)")
        mesh = self.mesh
        dp = mesh.shape["dp"] if mesh is not None else 1
        if mesh is not None and pass_spp % mesh.shape["sp"]:
            raise ValueError(f"pass spp {pass_spp} must divide by the sp mesh axis {mesh.shape['sp']}; choose spp "
                             f"and spp_per_pass multiples of sp")
        n_px = cfg.width * cfg.height
        px_per_chunk = max(1, min(n_px, cfg.max_lanes))
        px_per_chunk = max(dp, px_per_chunk - px_per_chunk % dp)  # a multiple of dp
        key = rnd.fold_in(rnd.PRNGKey(self.seed), 1 + self.spp_done)  # one stream per sample offset
        device = self.scene.device
        t0 = time.time()
        with torch.no_grad():
            for c in range((n_px + px_per_chunk - 1) // px_per_chunk):
                lo = c * px_per_chunk
                hi = min(lo + px_per_chunk, n_px)
                px = torch.arange(lo, hi, dtype=torch.int32, device=device)
                if mesh is not None:
                    px, n_real = _pad_to(px, dp)
                    sum_v, sum_a = sharded_sample_sums(self.scene, self.tables, cfg, mesh, rnd.fold_in(key, c), px,
                                                       pass_spp)
                    sum_v, sum_a = sum_v[:n_real], sum_a[:n_real]
                else:
                    sum_v, sum_a = _render_chunk(self.scene, self.tables, cfg, rnd.fold_in(key, c), px, pass_spp)
                with span("ss.readback"):  # waits for the chunk's kernels, then copies
                    sum_v, sum_a = sum_v.cpu().numpy(), sum_a.cpu().numpy()
                with span("ss.host_add"):
                    if self._fb is not None:
                        self._fb.add_chunk(lo, sum_v, sum_a)
                    else:
                        self._sum_value[lo:hi] += sum_v.astype(np.float64)
                        self._sum_alpha[lo:hi] += sum_a.astype(np.float64)
        if self._fb is not None:
            self._fb.note_pass(pass_spp)
        else:
            self._spp_done += pass_spp
        self.metrics.record_pass(pass_spp, time.time() - t0)
        return self.spp_done

    def run(self, checkpoint_every: int = 0, progress: bool = False, on_pass=None):
        """Render until cfg.spp samples are accumulated.

        ``on_pass(self)`` is called after every pass: the hook behind the
        CLI's ``--window`` live preview."""
        n_pass = 0
        while self.spp_done < self.cfg.spp:
            self.run_pass()
            n_pass += 1
            if on_pass is not None:
                on_pass(self)
            if progress:
                print(f"\rpass {n_pass}: {self.spp_done}/{self.cfg.spp} spp, "
                      f"{self.metrics.mrays_per_s:.1f} Mrays/s", end="", flush=True)
            if checkpoint_every and self.checkpoint_path and n_pass % checkpoint_every == 0:
                # asynchronous on the native backend: the write overlaps the next pass
                self.save_checkpoint(wait=False)
        if progress:
            print()
        if self.checkpoint_path:
            self.save_checkpoint(wait=True)

    # --- output ---

    def mean_value(self):
        """(value f64[H, W, 3], alpha f64[H, W]), row 0 at the bottom."""
        h, w = self.cfg.height, self.cfg.width
        if self._fb is not None:
            return self._fb.mean()
        spp = max(self.spp_done, 1)
        return (self._sum_value / spp).reshape(h, w, 3), (self._sum_alpha / spp).reshape(h, w)

    def image(self) -> np.ndarray:
        value, alpha = self.mean_value()
        return finalize_srgb(self.cfg, self.tables, value, alpha)

    def image_u8(self, flip_rows: bool = True) -> np.ndarray:
        """u8 RGBA through the native tonemap when available (the exact sRGB
        gamma and the XYZ->lRGB matrix in C++), else quantized from
        :meth:`image`."""
        if self._fb is not None:
            from simple_spectral_torch.spectra.colorimetry import MENG_M_XYZ_TO_RGB

            if self.cfg.mode == MODE_MENG:
                # Meng's legacy matrix with the Y-whitepoint divide folded in
                # (reference src/util/color.cpp:243-254)
                m = (MENG_M_XYZ_TO_RGB / float(self.tables.d65_rad_xyz[1])).astype(np.float32)
            elif self.cfg.spectral:
                m = self.tables.matr_xyz_to_lrgb.cpu().numpy().astype(np.float32)
            else:
                m = np.eye(3, dtype=np.float32)
            return self._fb.tonemap_srgb_u8(m, flip_rows=flip_rows)
        fb = self.image()
        if flip_rows:
            fb = fb[::-1]
        return np.clip(np.round(fb * 255.0), 0, 255).astype(np.uint8)
