"""Transfer function tests (reference src/transfer_function.rs)."""

import jax
import jax.numpy as jnp
import numpy as np

from volym.transfer_function import (
    ControlPoint,
    TransferFunction,
    lut_sample,
    quantize_lut,
)


def _rust_build_linear(points, n, channel_slice):
    """Literal transcription of build_linear (src/transfer_function.rs:80-125)."""
    out = np.zeros((n, 4), np.float32)
    pts = sorted(points, key=lambda p: p.iso_value)
    for a, b in zip(pts[:-1], pts[1:]):
        s, e = int(a.iso_value * (n - 1)), int(b.iso_value * (n - 1))
        for x in range(s, e + 1):
            k = 0.0 if e == s else (x - s) / (e - s)
            for c in channel_slice:
                out[x, c] = a.color[c] + (b.color[c] - a.color[c]) * k
    return out


def test_default_lut_matches_rust_loop():
    tf = TransferFunction.default()
    lut = tf.build_lut()
    rust_rgb = _rust_build_linear(tf.rgb_points, 256, range(3))
    rust_a = _rust_build_linear(tf.alpha_points, 256, [3])
    np.testing.assert_allclose(lut[:, :3], rust_rgb[:, :3], atol=1e-6)
    np.testing.assert_allclose(lut[:, 3], rust_a[:, 3], atol=1e-6)


def test_default_lut_landmarks():
    lut = TransferFunction.default().build_lut()
    np.testing.assert_allclose(lut[0], [0, 1, 0, 0], atol=1e-6)  # green, transparent
    np.testing.assert_allclose(lut[255], [1, 0, 0, 1], atol=1e-6)  # red, opaque
    np.testing.assert_allclose(lut[51, :3], [0, 1, 1], atol=1e-6)  # cyan at 0.2
    np.testing.assert_allclose(lut[:, 3], np.arange(256) / 255.0, atol=1e-6)  # linear alpha


def test_get_interpolates():
    tf = TransferFunction.default()
    v = tf.get(0.1)  # halfway green->cyan
    np.testing.assert_allclose(v[:3], [0.0, 1.0, 0.5], atol=0.03)


def test_lut_sample_texture_convention():
    lut = jnp.asarray(TransferFunction.default().build_lut())
    # texel centres: density = (i + 0.5)/256 returns row i exactly
    for i in (0, 7, 100, 255):
        got = lut_sample(lut, jnp.float32((i + 0.5) / 256.0))
        np.testing.assert_allclose(np.asarray(got), np.asarray(lut[i]), atol=1e-6)
    # clamp-to-edge below the first texel centre
    got = lut_sample(lut, jnp.float32(0.0))
    np.testing.assert_allclose(np.asarray(got), np.asarray(lut[0]), atol=1e-6)


def test_lut_sample_differentiable():
    lut = jnp.asarray(TransferFunction.default().build_lut())
    g = jax.grad(lambda l: jnp.sum(lut_sample(l, jnp.array([0.3, 0.7]))))(lut)
    assert np.asarray(g).sum() > 0
    gd = jax.grad(lambda d: jnp.sum(lut_sample(lut, d)))(jnp.float32(0.3))
    assert np.isfinite(float(gd))


def test_quantize_roundtrip():
    lut = TransferFunction.default().build_lut()
    q = quantize_lut(lut)
    assert np.abs(q - lut).max() <= 1.0 / 255.0 + 1e-6


def test_unsorted_insertion_sorts():
    tf = TransferFunction()
    tf.add_rgb(ControlPoint((1, 0, 0, 1), 1.0))
    tf.add_rgb(ControlPoint((0, 1, 0, 1), 0.0))
    assert tf.rgb_points[0].iso_value == 0.0
