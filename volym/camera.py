"""Orbit camera and differentiable view/projection math.

Analog of the reference's host camera (``src/camera.rs:4-117``)
plus its GPU uniform mirror (``src/gpu_resources/camera.rs:56-85``).  The
reference uploads ``view``, ``proj``, ``inverse_view_proj = view^-1 @ proj^-1``
(note the order at ``src/gpu_resources/camera.rs:72-76``) and the camera
position each frame; here the same quantities are a pytree produced by pure
functions so they trace under ``jax.jit`` and differentiate under
``jax.grad`` (camera-pose gradients are a first-class BASELINE.json target).

Matrix conventions replicate cgmath exactly: ``look_at_rh`` and the
OpenGL-style ``perspective`` (depth to [-1, 1]).  Inverses are closed-form —
a rigid-transform inverse for the view and an analytic perspective inverse —
which is both faster and better conditioned than a general 4x4 inverse, and
keeps the whole pipeline differentiable without ``jnp.linalg.inv``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (cgmath ``Matrix4::look_at_rh``).

    Reference use: ``src/camera.rs:63-67``.  Acts on column vectors.
    """
    xp = jnp if _traced(eye, target, up) else np
    eye = xp.asarray(eye, dtype=xp.float32)
    target = xp.asarray(target, dtype=xp.float32)
    up = xp.asarray(up, dtype=xp.float32)
    f = _normalize(target - eye, xp)
    s = _normalize(xp.cross(f, up), xp)
    u = xp.cross(s, f)
    rot = xp.stack([s, u, -f])  # rows
    # elementwise matvec: full f32 whatever the matmul precision (see
    # unproject_ndc)
    trans = -xp.sum(rot * eye[None, :], axis=1)
    m = xp.zeros((4, 4), dtype=xp.float32)
    if xp is np:
        m[:3, :3] = rot
        m[:3, 3] = trans
        m[3, 3] = 1.0
        return m
    m = m.at[:3, :3].set(rot).at[:3, 3].set(trans).at[3, 3].set(1.0)
    return m


def look_at_rh_inverse(eye, target, up):
    """Closed-form inverse of :func:`look_at_rh` (rigid transform)."""
    xp = jnp if _traced(eye, target, up) else np
    eye = xp.asarray(eye, dtype=xp.float32)
    target = xp.asarray(target, dtype=xp.float32)
    up = xp.asarray(up, dtype=xp.float32)
    f = _normalize(target - eye, xp)
    s = _normalize(xp.cross(f, up), xp)
    u = xp.cross(s, f)
    rot_t = xp.stack([s, u, -f], axis=-1)  # columns = rows of view rotation
    m = xp.zeros((4, 4), dtype=xp.float32)
    if xp is np:
        m[:3, :3] = rot_t
        m[:3, 3] = eye
        m[3, 3] = 1.0
        return m
    m = m.at[:3, :3].set(rot_t).at[:3, 3].set(eye).at[3, 3].set(1.0)
    return m


def perspective_gl(fovy_deg: float, aspect: float, znear: float, zfar: float):
    """OpenGL-convention perspective matrix (cgmath ``perspective``).

    Reference use: ``src/camera.rs:69-73``.
    """
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    return m


def perspective_gl_inverse(fovy_deg: float, aspect: float, znear: float, zfar: float):
    """Analytic inverse of :func:`perspective_gl`."""
    f = 1.0 / np.tan(np.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = aspect / f
    m[1, 1] = 1.0 / f
    m[2, 3] = -1.0
    m[3, 2] = (znear - zfar) / (2.0 * zfar * znear)
    m[3, 3] = (zfar + znear) / (2.0 * zfar * znear)
    return m


def _normalize(v, xp):
    return v / xp.sqrt(xp.sum(v * v))


def _traced(*args: Any) -> bool:
    return any(isinstance(a, jnp.ndarray) and not isinstance(a, np.ndarray) for a in args)


@dataclass(frozen=True)
class Camera:
    """Orbit camera (reference ``src/camera.rs:4-74``).

    Defaults mirror ``Camera::default_with_aspect_and_pos``
    (``src/camera.rs:22-45``): target box centre, +Y up, 90 deg fovy,
    znear 0.01, zfar 1000, orbit distance clamped to [1, 10].

    Reference quirk preserved: ``State::update`` runs ``orbit(0,0,0)`` every
    frame (``src/state.rs:153-155`` -> ``src/camera.rs:110-116``), so the
    *effective* position is always derived from (angles, distance) around the
    target — an explicitly passed position only survives until the first
    update.  Here :meth:`position` is always derived, and the explicit
    ``position`` field (if set) is what :meth:`raw_position` returns for
    parity tests of the pre-update state.
    """

    aspect: float = 1.0
    target: tuple[float, float, float] = (0.5, 0.5, 0.5)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fovy: float = 90.0
    znear: float = 0.01
    zfar: float = 1000.0
    horizontal_angle: float = 0.0
    vertical_angle: float = 0.0
    distance: float = 1.0
    min_distance: float = 1.0
    max_distance: float = 10.0
    explicit_position: tuple[float, float, float] | None = None

    # -- orbit dynamics (reference src/camera.rs:47-61) ------------------
    def orbit(self, dh: float, dv: float, dzoom: float) -> "Camera":
        h = self.horizontal_angle + dh
        v = float(np.clip(self.vertical_angle + dv, -89.0, 89.0))
        d = float(np.clip(self.distance + dzoom, self.min_distance, self.max_distance))
        return replace(
            self, horizontal_angle=h, vertical_angle=v, distance=d, explicit_position=None
        )

    @property
    def position(self) -> np.ndarray:
        if self.explicit_position is not None:
            return np.asarray(self.explicit_position, dtype=np.float32)
        h = np.radians(self.horizontal_angle)
        v = np.radians(self.vertical_angle)
        t = np.asarray(self.target, dtype=np.float32)
        return np.array(
            [
                t[0] + self.distance * np.sin(h) * np.cos(v),
                t[1] + self.distance * np.sin(v),
                t[2] + self.distance * np.cos(h) * np.cos(v),
            ],
            dtype=np.float32,
        )

    # -- matrix uniforms (reference src/gpu_resources/camera.rs:56-85) ----
    def matrices(self) -> "CameraMatrices":
        return camera_matrices(
            self.position,
            np.asarray(self.target, np.float32),
            np.asarray(self.up, np.float32),
            self.fovy,
            self.aspect,
            self.znear,
            self.zfar,
        )


@dataclass
class CameraMatrices:
    """Pytree mirror of the reference's ``CameraUniforms``
    (``src/gpu_resources/camera.rs:56-64``)."""

    view: Any
    proj: Any
    inverse_view_proj: Any
    position: Any

    def tree_flatten(self):
        return (self.view, self.proj, self.inverse_view_proj, self.position), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)


import jax.tree_util  # noqa: E402

jax.tree_util.register_pytree_node(
    CameraMatrices, CameraMatrices.tree_flatten, CameraMatrices.tree_unflatten
)


def camera_matrices(position, target, up, fovy, aspect, znear, zfar) -> CameraMatrices:
    """Build the full uniform set.  Differentiable w.r.t. ``position``
    (and target/up) when given traced inputs.

    ``inverse_view_proj = view^-1 @ proj^-1`` replicates the order in
    ``src/gpu_resources/camera.rs:72-76``.
    """
    xp = jnp if _traced(position, target, up) else np
    view = look_at_rh(position, target, up)
    view_inv = look_at_rh_inverse(position, target, up)
    proj = xp.asarray(perspective_gl(fovy, aspect, znear, zfar))
    proj_inv = xp.asarray(perspective_gl_inverse(fovy, aspect, znear, zfar))
    if xp is jnp:
        # full-f32 4x4 product: DEFAULT matmul precision may run in TF32
        # (or bf16-class passes) and corrupts ray directions at the 1e-3
        # level
        ivp = jnp.matmul(view_inv, proj_inv, precision=jax.lax.Precision.HIGHEST)
    else:
        ivp = view_inv @ proj_inv
    return CameraMatrices(
        view=view,
        proj=proj,
        inverse_view_proj=ivp,
        position=xp.asarray(position, dtype=xp.float32),
    )


@dataclass
class CameraController:
    """Accumulates input deltas, applied once per frame then reset
    (reference ``src/camera.rs:76-117``)."""

    sensitivity: float = 0.2
    zoom_sensitivity: float = 0.2
    rotate_horizontal: float = 0.0
    rotate_vertical: float = 0.0
    scroll: float = 0.0

    def process_mouse(self, dx: float, dy: float) -> None:
        self.rotate_horizontal = -dx * self.sensitivity
        self.rotate_vertical = -dy * self.sensitivity

    def process_scroll(self, delta: float) -> None:
        self.scroll = -delta * self.zoom_sensitivity

    def update_camera(self, camera: Camera) -> Camera:
        cam = camera.orbit(self.rotate_horizontal, self.rotate_vertical, self.scroll)
        self.rotate_horizontal = 0.0
        self.rotate_vertical = 0.0
        self.scroll = 0.0
        return cam
