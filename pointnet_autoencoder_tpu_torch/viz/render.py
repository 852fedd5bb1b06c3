"""Point-cloud rendering: offline z-buffer ball splatting, the port's
counterpart of ``pointnet_autoencoder_tpu/viz/render.py``.

The role of the reference's viewer stack (utils/show3d_balls.py and
render_balls_so.cpp): orthographic projection with mouse-style x/y
rotation angles, depth-shaded sphere splats, z-buffer occlusion. The
primary API renders to a numpy image or an image file (headless); an
interactive OpenCV loop exists where ``cv2`` imports.

Rasterization runs in native host C++ (``csrc/render_balls.cpp``, built
with g++ at first use into ``csrc/_build/`` and bound with ``ctypes``);
a failed build raises. ``_render_numpy`` is the plain version beside it,
reached only by name (tests and the on-card smoke run compare the two).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from pointnet_autoencoder_tpu_torch.csrc import build

_SIGNATURES = {"render_spheres": (
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], None)}


def native_library() -> ctypes.CDLL:
    """The renderer's library, built at first use."""
    return build.load("render_balls", _SIGNATURES)


def _rotation(xangle: float, yangle: float) -> np.ndarray:
    cx, sx = np.cos(xangle), np.sin(xangle)
    cy, sy = np.cos(yangle), np.sin(yangle)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
    ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], np.float32)
    return rx @ ry


def project(xyz: np.ndarray, size: int, xangle: float = 0.0,
            yangle: float = 0.0, zoom: float = 1.0) -> np.ndarray:
    """Center/scale a cloud and project to pixel coordinates (x, y, depth)."""
    pts = np.asarray(xyz, np.float32)
    pts = pts - pts.mean(axis=0)
    radius = np.max(np.linalg.norm(pts, axis=1)) + 1e-9
    pts = pts * (size / (radius * 2.2)) * zoom
    pts = pts @ _rotation(xangle, yangle).T
    out = np.empty_like(pts)
    out[:, 0] = pts[:, 0] + size / 2.0  # x -> column
    out[:, 1] = pts[:, 1] + size / 2.0  # y -> row
    out[:, 2] = pts[:, 2]               # depth (larger = nearer)
    return out


def _render_numpy(img, proj, rgb, radius):
    """The plain version of ``render_spheres``: splat the projected points
    ``proj`` (n, 3) with colors ``rgb`` (n, 3) into ``img`` (h, w, 3)
    uint8, in place, far to near; returns ``img``."""
    h, w, _ = img.shape
    r2 = radius * radius
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = (dx * dx + dy * dy) < r2
    dx, dy = dx[mask], dy[mask]
    dz = np.sqrt(r2 - dx * dx - dy * dy).astype(np.float32)
    shade = dz / radius
    zmin, zmax = proj[:, 2].min(), proj[:, 2].max()
    span = max(zmax - zmin, 1e-6)
    zbuf = np.full((h, w), -np.inf, np.float32)
    # Paint far-to-near; later (nearer) points overwrite.
    order = np.argsort(proj[:, 2])
    for i in order:
        x = int(round(proj[i, 0])) + dx
        y = int(round(proj[i, 1])) + dy
        z = proj[i, 2] + dz
        ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        x, y, zv, sh = x[ok], y[ok], z[ok], shade[ok]
        upd = zbuf[y, x] < zv
        x, y, zv, sh = x[upd], y[upd], zv[upd], sh[upd]
        zbuf[y, x] = zv
        gain = (0.3 + 0.7 * (proj[i, 2] - zmin) / span) * sh
        img[y, x] = np.minimum(255.0, rgb[i][None, :] * gain[:, None])
    return img


def render_points(xyz: np.ndarray, colors: Optional[np.ndarray] = None,
                  size: int = 800, ballradius: int = 10,
                  background: Tuple[int, int, int] = (0, 0, 0),
                  xangle: float = 0.0, yangle: float = 0.0,
                  zoom: float = 1.0, normalizecolor: bool = True
                  ) -> np.ndarray:
    """Render a cloud to an (size, size, 3) uint8 RGB image, with the
    native renderer."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if colors is None:
        rgb = np.full((n, 3), 255.0, np.float32)
    else:
        rgb = np.asarray(colors, np.float32).reshape(n, 3).copy()
        if normalizecolor:
            rgb *= 255.0 / (rgb.max() + 1e-14)
    img = np.empty((size, size, 3), np.uint8)
    img[:] = np.asarray(background, np.uint8)
    proj = np.ascontiguousarray(project(xyz, size, xangle, yangle, zoom),
                                np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    native_library().render_spheres(
        size, size, img.ctypes.data_as(ctypes.c_void_p), n,
        proj.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p), int(ballradius))
    return img


def save_image(img: np.ndarray, path: str) -> None:
    """PNG via PIL when available, else PPM (pure python)."""
    try:
        from PIL import Image  # type: ignore

        Image.fromarray(img).save(path)
        return
    except Exception:
        pass
    if not path.endswith(".ppm"):
        path = os.path.splitext(path)[0] + ".ppm"
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())


def group_colors(num_point: int, num_group: int,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-point colors for --num_group visualization of hierarchical
    decoders (test.py:86-93): contiguous blocks of num_point//num_group
    points share a random color. When num_group does not divide num_point
    the trailing remainder points stay colored (0,0,0) -- exactly the
    reference's Python-2 integer-division behavior (test.py:92)."""
    rng = rng or np.random.default_rng(0)
    colors = rng.random((num_group, 3)).astype(np.float32)
    per = num_point // num_group
    out = np.zeros((num_point, 3), np.float32)
    for g in range(num_group):
        out[g * per:(g + 1) * per] = colors[g]
    return out


def magnify_blue(img: np.ndarray, level: int, channel: int = 2) -> np.ndarray:
    """Dilate the blue channel by 1px (level 1: down+right, level >=2: all
    four directions) -- the reference's magnifyBlue post-pass
    (show3d_balls.py:88-93). ``channel`` is 2 because images here are RGB
    (the reference operates on channel 0 of its BGR buffer)."""
    if level <= 0:
        return img
    c = img[:, :, channel]
    c = np.maximum(c, np.roll(c, 1, axis=0))
    if level >= 2:
        c = np.maximum(c, np.roll(c, -1, axis=0))
    c = np.maximum(c, np.roll(c, 1, axis=1))
    if level >= 2:
        c = np.maximum(c, np.roll(c, -1, axis=1))
    img[:, :, channel] = c
    return img


class ViewerSession:
    """State machine behind the interactive viewer, driveable without cv2.

    Mirrors the reference's show3d_balls.showpoints loop observables
    (show3d_balls.py:25-158): mouse position maps to x/y rotation angles
    unless frozen, hotkeys mutate zoom/colors/freeze, and a frame is only
    re-rendered when an event marks the state changed. In particular the
    'f' freeze toggle (show3d_balls.py:155-156) does NOT mark the state
    changed -- the displayed frame keeps the last drag angles until the
    next mouse/color/zoom event, whose re-render then uses angle 0 while
    frozen (show3d_balls.py:53-66)."""

    def __init__(self, xyz, c_gt=None, c_pred=None, showrot=False,
                 magnifyBlue=0, freezerot=False, ballradius=10,
                 size=800, **kwargs):
        self.xyz = xyz
        self.c_gt, self.c_pred = c_gt, c_pred
        self.showrot, self.magnify = showrot, magnifyBlue
        self.ballradius, self.size, self.kwargs = ballradius, size, kwargs
        self.colors = c_gt
        self.mx = self.my = 0.5          # normalized mouse position
        self.zoom = 1.0
        self.frozen = bool(freezerot)
        self.changed = True
        self.img = None
        self.rendered_angles = (0.0, 0.0)  # angles of the displayed frame

    def on_mouse(self, px: float, py: float) -> None:
        """Mouse-move callback in pixel coordinates."""
        self.mx, self.my = px / float(self.size), py / float(self.size)
        self.changed = True

    def current_angles(self):
        if self.frozen:
            return 0.0, 0.0
        return ((self.my - 0.5) * np.pi * 1.2,
                (self.mx - 0.5) * np.pi * 1.2)

    def render_if_needed(self) -> np.ndarray:
        """Re-render only when an event marked the state changed; otherwise
        keep showing the previous frame (and its angles)."""
        if self.changed or self.img is None:
            xangle, yangle = self.current_angles()
            img = render_points(
                self.xyz, self.colors, ballradius=self.ballradius,
                size=self.size, xangle=xangle, yangle=yangle,
                zoom=self.zoom, **self.kwargs,
            )
            if self.magnify > 0:
                img = magnify_blue(img, self.magnify)
            if self.showrot:
                self._overlay_rot(img, xangle, yangle)
            self.img = img
            self.rendered_angles = (xangle, yangle)
            self.changed = False
        return self.img

    def _overlay_rot(self, img, xangle, yangle):
        import cv2  # type: ignore

        for i, text in enumerate((
                "xangle %d" % int(xangle / np.pi * 180),
                "yangle %d" % int(yangle / np.pi * 180),
                "zoom %d%%" % int(self.zoom * 100))):
            cv2.putText(img, text, (30, self.size - 30 - 20 * i), 0, 0.5,
                        (255, 0, 0))

    def handle_key(self, cmd: int) -> Optional[str]:
        """Apply one hotkey. Returns 'quit' for q, 'exit' for Q, else None."""
        if cmd == ord("q"):
            return "quit"
        if cmd == ord("Q"):
            return "exit"
        if cmd == ord("t"):
            self.colors, self.changed = self.c_gt, True
        elif cmd == ord("p"):
            self.colors, self.changed = self.c_pred, True
        elif cmd == ord("n"):
            self.zoom *= 1.1
            self.changed = True
        elif cmd == ord("m"):
            self.zoom /= 1.1
            self.changed = True
        elif cmd == ord("r"):
            self.zoom = 1.0
            self.changed = True
        elif cmd == ord("s"):
            if self.img is not None:  # nothing rendered yet: no-op
                save_image(self.img, "pcae_view.png")
        elif cmd == ord("f"):
            # Reference parity (show3d_balls.py:155-156): toggle without
            # re-rendering, so the frame freezes at the last drag angles.
            self.frozen = not self.frozen
        return None


def showpoints(xyz: np.ndarray, c_gt: Optional[np.ndarray] = None,
               c_pred: Optional[np.ndarray] = None, waittime: int = 0,
               showrot: bool = False, magnifyBlue: int = 0,
               freezerot: bool = False, ballradius: int = 10,
               size: int = 800, **kwargs):
    """Interactive viewer (requires cv2 + display), hotkey-compatible with
    the reference's show3d_balls.showpoints (show3d_balls.py:25-158):
    drag to rotate (unless frozen), t/p ground-truth vs predicted colors,
    n/m zoom in/out, r reset zoom, s save PNG, f freeze rotation at the
    current frame, q quit the viewer, Q exit the process. ``showrot``
    overlays the current angles/zoom; ``magnifyBlue`` dilates the blue
    channel; ``waittime`` nonzero renders one frame and returns the
    pressed key. Headless environments should use
    render_points()/save_image() instead."""
    try:
        import cv2  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "showpoints needs opencv; use render_points()/save_image() "
            "for headless rendering"
        ) from e

    session = ViewerSession(
        xyz, c_gt=c_gt, c_pred=c_pred, showrot=showrot,
        magnifyBlue=magnifyBlue, freezerot=freezerot,
        ballradius=ballradius, size=size, **kwargs,
    )

    def on_mouse(event, mx, my, flags, param):
        session.on_mouse(mx, my)

    cv2.namedWindow("pcae")
    cv2.setMouseCallback("pcae", on_mouse)
    while True:
        img = session.render_if_needed()
        cv2.imshow("pcae", img[:, :, ::-1])
        cmd = cv2.waitKey(10 if waittime == 0 else waittime) % 256
        action = session.handle_key(cmd)
        if action == "quit":
            break
        if action == "exit":
            import sys

            sys.exit(0)
        if waittime != 0:
            break
    cv2.destroyWindow("pcae")
    return cmd
