"""Carry scene and colour-table state across frameworks as numpy.

``scene_from_numpy`` and ``tables_from_numpy`` build the port's objects from
the leaves of the JAX package's ``SceneData`` / ``ColorTables`` given as a
dict of numpy arrays and plain Python values (nested dicts for ``materials``
and ``camera``, and for the ``meng`` and ``jakob`` colour tables, whose ints
and floats stay Python numbers); the caller does the ``np.asarray`` on the
JAX side, so this module imports no JAX.  Texel words (u32 there) are held
as int32 with the same bits.  The material tables named in ``DIFF_FIELDS``
are the renderer's trainable "weights".  ``scene_to_numpy`` /
``tables_to_numpy`` go the other way, in the same layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simple_spectral_torch import resolve_device
from simple_spectral_torch.scene.types import Camera, MaterialTable, SceneData
from simple_spectral_torch.spectra.colorimetry import ColorTables

# The differentiable material leaves (the JAX package's trainstep.DIFF_FIELDS).
DIFF_FIELDS = ("albedo_values", "emission_values", "albedo_rgb", "emission_rgb")


def _tensor(a, device):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.uint32:  # texel words: the port holds their bits as int32
        a = a.view(np.int32)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a), device=device)  # a writable copy


def _value(v, device):
    """A numpy array becomes a tensor; a dict (the meng and jakob tables)
    has its arrays converted and keeps its Python ints and floats."""
    if isinstance(v, np.ndarray):
        return _tensor(v, device)
    if isinstance(v, dict):
        return {k: _value(x, device) for k, x in v.items()}
    return v


def _from_numpy(cls, leaves: dict, device, nested=None):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in leaves:
            continue
        v = leaves[f.name]
        if nested and f.name in nested:
            kw[f.name] = _from_numpy(nested[f.name], v, device)
        else:
            kw[f.name] = _value(v, device)
    return cls(**kw)


def _numpy_value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _numpy_value(x) for k, x in v.items()}
    return v


def _to_numpy(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_numpy(v)
        elif f.name != "host":
            out[f.name] = _numpy_value(v)
    return out


def scene_from_numpy(leaves: dict, device="cuda") -> SceneData:
    """SceneData from numpy leaves, spheres, BVH and cluster tiles included."""
    device = resolve_device(device)
    return _from_numpy(SceneData, leaves, device, nested={"materials": MaterialTable, "camera": Camera})


def tables_from_numpy(leaves: dict, device="cuda") -> ColorTables:
    """ColorTables from numpy leaves, the meng and jakob dicts included."""
    device = resolve_device(device)
    return _from_numpy(ColorTables, leaves, device)


def scene_to_numpy(scene: SceneData) -> dict:
    return _to_numpy(scene)


def tables_to_numpy(tables: ColorTables) -> dict:
    return _to_numpy(tables)
