"""3D math: Mat4 helpers with glam-compatible conventions.

The reference uses ``glam`` (ref: src/render_objects/camera.rs:4,40-47) with
column-vector math and the Vulkan [0,1] NDC depth range.  All functions
return row-major f32 ``(4, 4)`` arrays ``M`` acting on column vectors:
``clip = M @ [x, y, z, 1]``.

Implemented in NUMPY on purpose: scene assembly runs on the host every frame
(immediate-mode, like the reference), and eager jnp math on tiny matrices
costs a device dispatch per op.
The jitted frame program does its own matrix math in jnp
(rendering/forward.py) with HIGHEST precision.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def identity(dtype=np.float32):
    return np.eye(4, dtype=dtype)


def perspective_rh(fov_y_radians, aspect_ratio, z_near, z_far):
    """Right-handed perspective projection, depth range [0, 1].

    Bit-for-bit the formula of ``glam::Mat4::perspective_rh`` used by the
    reference camera (ref: src/render_objects/camera.rs:40-47): looking down
    -Z, ``z = -z_near`` maps to NDC depth 0 and ``z = -z_far`` to 1.
    """
    fov = np.float32(fov_y_radians)
    h = np.float32(np.cos(fov * 0.5) / np.sin(fov * 0.5))
    w = np.float32(h / np.float32(aspect_ratio))
    zn = np.float32(z_near)
    zf = np.float32(z_far)
    r = np.float32(zf / (zn - zf))
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * zn
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up):
    """Right-handed view matrix (glam ``Mat4::look_at_rh`` semantics)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def translation(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def scale(v):
    v = np.asarray(v, np.float32)
    return np.diag(np.array([v[0], v[1], v[2], 1.0], np.float32))


def _rot(c, s, axis):
    m = np.eye(4, dtype=np.float32)
    if axis == 0:
        m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    elif axis == 1:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    else:
        m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rotation_x(angle):
    a = np.float32(angle)
    return _rot(np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32), 0)


def rotation_y(angle):
    a = np.float32(angle)
    return _rot(np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32), 1)


def rotation_z(angle):
    a = np.float32(angle)
    return _rot(np.cos(a, dtype=np.float32), np.sin(a, dtype=np.float32), 2)


def compose(*mats):
    """Matrix product ``mats[0] @ mats[1] @ ...`` (applied right-to-left)."""
    out = np.asarray(mats[0], np.float32)
    for m in mats[1:]:
        out = out @ np.asarray(m, np.float32)
    return out


def transform_points(m, pts):
    """Apply a 4x4 to ``[N, 3]`` points; returns homogeneous ``[N, 4]``."""
    pts = np.asarray(pts, np.float32)
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,), pts.dtype)], axis=-1)
    return h @ np.asarray(m, np.float32).T


@dataclasses.dataclass(frozen=True)
class Viewport:
    """Vulkan-style viewport (ref: yarvk ``Viewport`` used at
    src/render_objects/camera.rs:15 and stages.rs:53-61).

    ``y`` grows downward in framebuffer space; NDC (-1,-1) maps to the
    viewport's top-left corner when ``height`` is positive.
    """

    x: float = 0.0
    y: float = 0.0
    width: float = 0.0
    height: float = 0.0
    min_depth: float = 0.0
    max_depth: float = 1.0

    def as_array(self):
        return np.array(
            [self.x, self.y, self.width, self.height, self.min_depth, self.max_depth],
            np.float32,
        )


@dataclasses.dataclass(frozen=True)
class Rect2D:
    """Vulkan-style scissor rect (offset + extent)."""

    x: int = 0
    y: int = 0
    width: int = 0
    height: int = 0

    def as_array(self):
        return np.array([self.x, self.y, self.width, self.height], np.int32)
