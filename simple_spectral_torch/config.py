"""Runtime render configuration (PyTorch port).

Field-for-field counterpart of ``simple_spectral_tpu.config.RenderConfig``:
the same fields, defaults, validation and derived ``lambda_*`` values, so a
configuration means the same render in both packages.  Kept as its own copy
because the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Render modes (reference src/stdafx.hpp:63-93).
MODE_RGB = "rgb"
MODE_MALLETT = "mallett"
MODE_MENG = "meng"
MODE_JAKOB = "jakob"
SPECTRAL_MODES = (MODE_MALLETT, MODE_MENG, MODE_JAKOB)
ALL_MODES = (MODE_RGB,) + SPECTRAL_MODES

INTERSECT_IMPLS = ("auto", "xla", "xla2", "pallas", "bvh", "cull")

# Wavelength ranges per observer (reference src/stdafx.hpp:115-123).
_LAMBDA_RANGE = {1931: (380.0, 780.0), 2006: (390.0, 830.0)}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render (see the JAX package's RenderConfig
    for the meaning of every field)."""

    # --- scene / image ---
    scene: str = "cornell"  # cornell | cornell-srgb | plane-srgb | cornell-stress
    width: int = 512
    height: int = 512
    spp: int = 64
    indirect_only: bool = False

    # --- color pipeline ---
    mode: str = MODE_MALLETT
    observer: int = 1931
    n_wavelengths: int = 4

    # --- integrator ---
    els: bool = True
    max_depth: int = 10
    flat_field: bool = True
    eps: float = 1e-3

    # --- execution shape ---
    max_lanes: int = 1 << 21
    # "auto" takes the block-cull kernel K2 (render/cull.py) for scenes with
    # cluster tiles from 32768 primitives on, else the closest-hit kernel K1
    # (render/intersect_pallas.py) with its exact key, as "xla" does; "xla2"
    # and "pallas" take K1 with its quantized key; "bvh" the skip-link BVH
    # walk (render/bvh.py).
    intersect_impl: str = "auto"
    unroll_geometry: bool = True
    remat_cache: bool = True
    debug_checks: bool = False
    bvh_threshold: int = 512
    bvh_leaf_size: int = 4
    cull_cluster_size: int = 63
    stress_boxes: int = 1000
    stress_spheres: int = 500
    stress_sphere_lights: int = 0
    stress_materials: int = 16
    stress_seed: int = 1234
    texel_format: str = "u32"
    texture: str = "crystal-lizard-512.png"

    def __post_init__(self):
        if self.mode not in ALL_MODES:
            raise ValueError(f"unknown mode {self.mode!r}; valid: {ALL_MODES}")
        if self.observer not in (1931, 2006):
            raise ValueError("observer must be 1931 or 2006")
        if self.n_wavelengths < 1:
            raise ValueError("n_wavelengths must be >= 1")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.intersect_impl not in INTERSECT_IMPLS:
            raise ValueError(
                "intersect_impl must be auto | xla | xla2 | pallas | bvh | cull"
            )
        if self.texel_format not in ("u32", "rows"):
            raise ValueError("texel_format must be u32 | rows")

    # --- derived quantities ---

    @property
    def spectral(self) -> bool:
        return self.mode != MODE_RGB

    @property
    def lambda_min(self) -> float:
        return _LAMBDA_RANGE[self.observer][0]

    @property
    def lambda_max(self) -> float:
        return _LAMBDA_RANGE[self.observer][1]

    @property
    def lambda_step(self) -> float:
        """Width of the band each hero wavelength covers (stdafx.hpp:289)."""
        return (self.lambda_max - self.lambda_min) / float(self.n_wavelengths)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
