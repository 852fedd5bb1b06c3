"""The port's renderer (viz/render.py over csrc/render_balls.cpp, built
with g++ at first use) against its plain version and the JAX package's
renderer, on the CPU.

Tolerance native against numpy, the JAX package's own
(tests/test_viz.py): fewer than 1% of pixels off by more than 2 (the two
round disc-edge depths differently). Projection, group colors, the blue
dilation and the viewer's state machine equal the JAX package's exactly.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.viz import render as jrender
from pointnet_autoencoder_tpu_torch.csrc import build
from pointnet_autoencoder_tpu_torch.viz import render

torch.set_num_threads(2)


def _cloud(n=200, seed=0):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32)


def _numpy_render(xyz, size, radius, colors=None, **kw):
    """render_points through the plain version."""
    n = len(xyz)
    rgb = (np.full((n, 3), 255.0, np.float32) if colors is None else
           np.asarray(colors, np.float32) * 255.0 / (colors.max() + 1e-14))
    img = np.zeros((size, size, 3), np.uint8)
    return render._render_numpy(img, render.project(xyz, size, **kw), rgb,
                                radius)


def _close_images(a, b):
    diff = np.abs(a.astype(int) - b.astype(int))
    return (diff > 2).mean() < 0.01


@pytest.mark.parametrize("seed,size,radius", [(3, 160, 5), (4, 200, 8),
                                              (5, 96, 1), (6, 300, 12)])
def test_native_matches_the_plain_version(seed, size, radius):
    xyz = _cloud(150, seed)
    img = render.render_points(xyz, size=size, ballradius=radius)
    assert img.shape == (size, size, 3) and img.dtype == np.uint8
    assert img.max() > 0 and img[0, 0].tolist() == [0, 0, 0]
    assert _close_images(img, _numpy_render(xyz, size, radius))


def test_native_matches_with_colors_and_angles():
    xyz = _cloud(300, 7)
    colors = render.group_colors(300, 4, np.random.default_rng(1))
    img = render.render_points(xyz, colors=colors, size=128, ballradius=4,
                               xangle=0.3, yangle=-1.1, zoom=1.3)
    want = _numpy_render(xyz, 128, 4, colors=colors, xangle=0.3,
                         yangle=-1.1, zoom=1.3)
    assert _close_images(img, want)


def test_native_renderer_hostile_coordinates():
    """NaN and far off-screen centers are skipped, not splatted through
    overflowing int arithmetic (tests/test_viz.py's case)."""
    lib = render.native_library()
    size = 64
    img = np.zeros((size, size, 3), np.uint8)
    proj = np.array([[np.nan, 10.0, 1.0], [10.0, np.nan, 1.0],
                     [1e12, 10.0, 1.0], [10.0, -1e12, 1.0],
                     [3e9, 3e9, 1.0]], np.float32)
    rgb = np.full((len(proj), 3), 255.0, np.float32)
    lib.render_spheres(size, size, img.ctypes.data_as(ctypes.c_void_p),
                       len(proj), proj.ctypes.data_as(ctypes.c_void_p),
                       rgb.ctypes.data_as(ctypes.c_void_p), 5)
    assert img.max() == 0


def test_renders_the_jax_package_s_image():
    """The port's native image against the JAX package's plain version
    (the JAX package's own renderer, whatever it has built)."""
    xyz = _cloud(250, 8)
    ours = render.render_points(xyz, size=180, ballradius=6)
    img = np.zeros((180, 180, 3), np.uint8)
    theirs = jrender._render_numpy(img, jrender.project(xyz, 180),
                                   np.full((250, 3), 255.0, np.float32), 6)
    assert _close_images(ours, theirs)
    np.testing.assert_array_equal(render.project(xyz, 180, 0.4, 0.2, 1.5),
                                  jrender.project(xyz, 180, 0.4, 0.2, 1.5))


@pytest.mark.parametrize("num_point,num_group", [(64, 4), (70, 4),
                                                 (2048, 1), (10, 3)])
def test_group_colors_equal_the_jax_package_s(num_point, num_group):
    ours = render.group_colors(num_point, num_group,
                               np.random.default_rng(3))
    theirs = jrender.group_colors(num_point, num_group,
                                  np.random.default_rng(3))
    np.testing.assert_array_equal(ours, theirs)
    rem = num_point % num_group
    if rem:  # the reference's remainder stays black
        assert not ours[-rem:].any()


@pytest.mark.parametrize("level", [0, 1, 2])
def test_magnify_blue_equals_the_jax_package_s(level):
    img = np.random.RandomState(level).randint(0, 255, (20, 30, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(render.magnify_blue(img.copy(), level),
                                  jrender.magnify_blue(img.copy(), level))


def test_viewer_session_follows_the_jax_package_s(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    xyz = _cloud(50, 9)
    kw = dict(size=64, ballradius=3, magnifyBlue=1)
    ours = render.ViewerSession(xyz, c_gt=None, c_pred=xyz, **kw)
    theirs = jrender.ViewerSession(xyz, c_gt=None, c_pred=xyz, **kw)
    events = [("mouse", 10, 50), ("key", "n"), ("key", "f"),
              ("mouse", 40, 5), ("key", "p"), ("key", "f"), ("key", "m"),
              ("key", "t"), ("key", "r"), ("key", "s"), ("key", "q")]
    for ev in events:
        for s in (ours, theirs):
            if ev[0] == "mouse":
                s.on_mouse(ev[1], ev[2])
                out = None
            else:
                out = s.handle_key(ord(ev[1]))
            s.render_if_needed()
        assert ours.rendered_angles == theirs.rendered_angles
        assert (ours.zoom, ours.frozen, ours.changed) == (
            theirs.zoom, theirs.frozen, theirs.changed)
        assert _close_images(ours.img, theirs.img)
    assert out == "quit" and os.path.exists("pcae_view.png")


def test_save_image_writes_png_or_ppm(tmp_path, monkeypatch):
    img = render.render_points(_cloud(30), size=40, ballradius=3)
    render.save_image(img, str(tmp_path / "a.png"))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    render.save_image(img, str(tmp_path / "b.png"))
    with open(tmp_path / "b.ppm", "rb") as f:
        assert f.read(11) == b"P6\n40 40\n25"


def test_the_renderer_builds_with_gxx_into_the_build_dir():
    path = build.library_path("render_balls")
    render.native_library()
    assert path.exists() and path.parent == build.BUILD_DIR
    assert path.name.startswith("render_balls-")


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    broken = tmp_path / "csrc"
    broken.mkdir()
    (broken / "render_balls.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "HERE", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="render_balls.cpp"):
        build.build(["render_balls"])
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build(["render_balls"])

    def no_library():
        raise RuntimeError("no renderer")

    monkeypatch.setattr(render, "native_library", no_library)
    with pytest.raises(RuntimeError, match="no renderer"):
        render.render_points(_cloud(10), size=32, ballradius=2)
