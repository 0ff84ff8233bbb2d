"""Camera math tests (reference src/camera.rs, src/gpu_resources/camera.rs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volym import camera as cam_mod
from volym.camera import Camera, CameraController


def test_orbit_matches_reference_formula():
    # src/camera.rs:47-61: position from spherical angles around target.
    cam = Camera(distance=2.0).orbit(30.0, 40.0, 0.5)
    h, v, d = np.radians(30.0), np.radians(40.0), 2.5
    expect = np.array(
        [0.5 + d * np.sin(h) * np.cos(v), 0.5 + d * np.sin(v), 0.5 + d * np.cos(h) * np.cos(v)]
    )
    np.testing.assert_allclose(cam.position, expect, rtol=1e-6)


def test_orbit_clamps():
    # vertical +-89 deg, distance [1, 10] (src/camera.rs:49-51).
    cam = Camera().orbit(0.0, 200.0, 100.0)
    assert cam.vertical_angle == 89.0
    assert cam.distance == 10.0
    cam = Camera().orbit(0.0, -200.0, -100.0)
    assert cam.vertical_angle == -89.0
    assert cam.distance == 1.0


def test_default_position_distance_quirk():
    # Reference quirk: State::update re-orbits every frame so an explicit
    # position collapses to target + distance*z (src/state.rs:153-155).
    cam = Camera(explicit_position=(0.5, 0.5, 3.5))
    np.testing.assert_allclose(cam.position, [0.5, 0.5, 3.5])
    cam = cam.orbit(0.0, 0.0, 0.0)
    np.testing.assert_allclose(cam.position, [0.5, 0.5, 1.5], atol=1e-6)


def test_view_matrix_properties():
    cam = Camera(distance=3.0).orbit(25.0, 10.0, 0.0)
    m = cam.matrices()
    view = np.asarray(m.view)
    # camera position maps to origin in view space
    p = view @ np.array([*cam.position, 1.0])
    np.testing.assert_allclose(p[:3], 0.0, atol=1e-5)
    # target maps onto -z axis
    t = view @ np.array([0.5, 0.5, 0.5, 1.0])
    np.testing.assert_allclose(t[:2], 0.0, atol=1e-5)
    assert t[2] < 0


def test_closed_form_inverses():
    cam = Camera(aspect=1.5, distance=2.5).orbit(33.0, -21.0, 0.0)
    m = cam.matrices()
    np.testing.assert_allclose(
        np.asarray(m.view) @ cam_mod.look_at_rh_inverse(cam.position, cam.target, cam.up),
        np.eye(4),
        atol=1e-5,
    )
    proj = cam_mod.perspective_gl(90.0, 1.5, 0.01, 1000.0)
    proj_inv = cam_mod.perspective_gl_inverse(90.0, 1.5, 0.01, 1000.0)
    np.testing.assert_allclose(proj @ proj_inv, np.eye(4), atol=1e-5)
    # inverse_view_proj = view^-1 @ proj^-1 (src/gpu_resources/camera.rs:72-76)
    np.testing.assert_allclose(
        np.asarray(m.inverse_view_proj),
        np.linalg.inv(np.asarray(m.view)) @ np.linalg.inv(np.asarray(m.proj)),
        atol=1e-4,
    )


def test_perspective_gl_convention():
    # z = -near maps to ndc z = -1; z = -far to +1 (OpenGL, cgmath).
    proj = cam_mod.perspective_gl(90.0, 1.0, 0.1, 100.0)
    for z, want in ((-0.1, -1.0), (-100.0, 1.0)):
        clip = proj @ np.array([0.0, 0.0, z, 1.0])
        assert clip[3] > 0 or z < -0.1
        np.testing.assert_allclose(clip[2] / clip[3], want, atol=1e-4)


def test_camera_matrices_differentiable():
    def f(pos):
        m = cam_mod.camera_matrices(
            pos, jnp.array([0.5, 0.5, 0.5]), jnp.array([0.0, 1.0, 0.0]), 90.0, 1.0, 0.01, 1000.0
        )
        return jnp.sum(m.inverse_view_proj) + jnp.sum(m.view)

    g = jax.grad(f)(jnp.array([0.5, 0.5, 3.5]))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.any(np.asarray(g) != 0)


def test_controller_accumulate_and_reset():
    # src/camera.rs:76-117
    ctl = CameraController(sensitivity=0.2, zoom_sensitivity=0.2)
    ctl.process_mouse(10.0, -5.0)
    ctl.process_scroll(2.0)
    cam = ctl.update_camera(Camera())
    assert cam.horizontal_angle == pytest.approx(-2.0)
    assert cam.vertical_angle == pytest.approx(1.0)
    assert cam.distance == pytest.approx(1.0)  # clamped at min 1.0
    assert ctl.rotate_horizontal == 0.0 and ctl.scroll == 0.0
