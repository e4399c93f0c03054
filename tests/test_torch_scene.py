"""The port's scenes, PNG codec and numpy conversion against the JAX
package, on the CPU.  Scene data is built on the host in float64 on both
sides and cast once, so every leaf must agree exactly."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from simple_spectral_torch import convert
from simple_spectral_torch.config import RenderConfig as TorchConfig
from simple_spectral_torch.io import image as timage
from simple_spectral_torch.scene import library as tlib
from simple_spectral_torch.scene import types as ttypes
from simple_spectral_torch.spectra.colorimetry import build_color_tables as t_build_tables
from simple_spectral_tpu.config import RenderConfig
from simple_spectral_tpu.scene import types as jtypes
from simple_spectral_tpu.scene.library import build_scene
from simple_spectral_tpu.spectra.colorimetry import build_color_tables

SCENES_DIR = os.path.join(os.path.dirname(__file__), "..", "simple_spectral_tpu", "data", "scenes")
CASES = [("cornell", "rgb"), ("cornell", "mallett"), ("cornell-srgb", "rgb"), ("cornell-srgb", "mallett")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def scenes(request):
    name, mode = request.param
    cfg = RenderConfig(scene=name, mode=mode, width=8, height=8)
    j_tables = build_color_tables(cfg)
    tcfg = TorchConfig(scene=name, mode=mode, width=8, height=8)
    t_tables = t_build_tables(tcfg, device="cpu")
    return build_scene(cfg, j_tables), tlib.build_scene(tcfg, t_tables, device="cpu"), j_tables, t_tables


def _assert_leaf(name, got, want):
    if want is None:
        assert got is None, name
    elif isinstance(got, torch.Tensor):
        want = np.asarray(want)
        assert got.shape == want.shape, name
        if want.dtype == np.uint32:  # packed texel words, held as int32 in the port
            assert got.dtype == torch.int32, name
            want = want.astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    else:
        assert got == want, name


def test_scene_leaves_exact(scenes):
    j_scene, t_scene, _, _ = scenes
    for f in dataclasses.fields(t_scene):
        if f.name in ("materials", "camera"):
            for g in dataclasses.fields(getattr(t_scene, f.name)):
                _assert_leaf(f"{f.name}.{g.name}", getattr(getattr(t_scene, f.name), g.name),
                             getattr(getattr(j_scene, f.name), g.name))
        else:
            _assert_leaf(f.name, getattr(t_scene, f.name), getattr(j_scene, f.name))
    # leaves of the JAX scene the port does not carry are all empty here
    for name in ("sphere_center", "bvh_nodes", "cull_tiles"):
        assert getattr(j_scene, name) is None


def test_convert_round_trips(scenes):
    j_scene, t_scene, j_tables, t_tables = scenes

    def leaves(obj):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                out[f.name] = leaves(v)
            elif f.name != "host":
                out[f.name] = v if v is None or isinstance(v, (int, float, str, tuple)) else np.asarray(v)
        return out

    from_jax = convert.scene_from_numpy(leaves(j_scene), device="cpu")
    again = convert.scene_from_numpy(convert.scene_to_numpy(t_scene), device="cpu")
    for s in (from_jax, again):
        for f in dataclasses.fields(t_scene):
            a, b = getattr(s, f.name), getattr(t_scene, f.name)
            if dataclasses.is_dataclass(b):
                for g in dataclasses.fields(b):
                    _assert_leaf(g.name, getattr(a, g.name), _np(getattr(b, g.name)))
            else:
                _assert_leaf(f.name, a, _np(b))
    tables = convert.tables_from_numpy(leaves(j_tables), device="cpu")
    for f in dataclasses.fields(t_tables):
        if f.name != "host":
            _assert_leaf(f.name, getattr(tables, f.name), _np(getattr(t_tables, f.name)))
    for name in convert.DIFF_FIELDS:
        assert getattr(from_jax.materials, name).dtype == torch.float32


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


@pytest.mark.parametrize("name", ["crystal-lizard-512.png", "test-img.png"])
def test_png_decoder_matches_pil(name):
    path = os.path.join(SCENES_DIR, name)
    np.testing.assert_array_equal(timage.load_png_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def test_png_writer_round_trips(tmp_path):
    rgba = np.random.default_rng(0).integers(0, 256, size=(9, 13, 4)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    timage.write_png_rgba(path, rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgba)
    # save_image: rows bottom to top in the framebuffer, top to bottom in the file
    fb = np.random.default_rng(1).uniform(0.0, 1.0, size=(5, 6, 4)).astype(np.float32)
    timage.save_image(path, fb)
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)), np.clip(np.round(fb * 255.0), 0, 255).astype(np.uint8)[::-1]
    )


@pytest.mark.parametrize("ext", [".pfm", ".hdr", ".csv"])
def test_other_image_formats_match_jax(tmp_path, ext):
    from simple_spectral_tpu.io.image import save_image as j_save

    fb = np.random.default_rng(2).uniform(0.0, 1.0, size=(4, 7, 4)).astype(np.float32)
    a, b = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    timage.save_image(a, fb)
    j_save(b, fb)
    with open(a, "rb") as fa, open(b, "rb") as fb_:
        assert fa.read() == fb_.read()


def test_camera_helpers_match():
    eye, center, up = np.array([1.0, 2.0, -3.0]), np.array([0.5, 0.1, 4.0]), np.array([0.0, 1.0, 0.0])
    np.testing.assert_array_equal(ttypes.look_at(eye, center, up), jtypes.look_at(eye, center, up))
    np.testing.assert_array_equal(ttypes.perspective_fov(0.7, 512.0, 256.0, 0.1, 1.0),
                                  jtypes.perspective_fov(0.7, 512.0, 256.0, 0.1, 1.0))


def test_unported_scenes_raise_and_default_device_needs_a_card(monkeypatch):
    """Every scene is ported now (plane-srgb was the last; it builds here in
    rgb mode, equal to the JAX package's), and so is the BVH arm: a scene
    asked for with intersect_impl="bvh" builds its skip-link BVH, equal to
    the JAX package's."""
    tables = t_build_tables(TorchConfig(mode="rgb"), device="cpu")
    plane = tlib.build_scene(TorchConfig(scene="plane-srgb", mode="rgb"), tables, device="cpu")
    j_plane = build_scene(RenderConfig(scene="plane-srgb", mode="rgb"), build_color_tables(RenderConfig(mode="rgb")))
    for name in ("tri_verts", "tri_mat", "light_prims", "texture"):
        _assert_leaf(name, getattr(plane, name), getattr(j_plane, name))
    bvh = tlib.build_scene(TorchConfig(mode="rgb", intersect_impl="bvh"), tables, device="cpu")
    j_bvh = build_scene(RenderConfig(mode="rgb", intersect_impl="bvh"), build_color_tables(RenderConfig(mode="rgb")))
    assert bvh.n_bvh_entries == j_bvh.n_bvh_entries > bvh.n_tris
    for name in ("bvh_nodes", "bvh_entry_ref", "bvh_entry_mat"):
        _assert_leaf(name, getattr(bvh, name), getattr(j_bvh, name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlib.build_scene(TorchConfig(mode="rgb"), tables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_tables(TorchConfig(mode="rgb"))
