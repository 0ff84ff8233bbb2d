"""Slab forward vs the NumPy oracle: coloring with shading, and Gaussian smoothing (plain and
shaded),
each with trilinear and nearest sampling, marching along all six axis
directions."""

import numpy as np
import pytest

import slab_oracle as so
from volym.render import slab


@pytest.mark.parametrize("direction", list(so.DIRECTIONS))
@pytest.mark.parametrize("interpolation", so.INTERPOLATIONS)
@pytest.mark.parametrize("mode", ["coloring_shading", "smoothing", "smoothing_shading"])
def test_forward_matches_oracle(mode, interpolation, direction):
    m = so.camera(direction).matrices()
    assert slab.dominant_axis(m) == so.expected_axis(direction)
    expect = so.oracle_image(mode, interpolation, direction)
    got = np.asarray(
        slab.render(so.scene(mode), m, so.params(mode, interpolation), so.RES, so.RES)
    )
    assert got.shape == (so.RES, so.RES, 4)
    assert (expect[..., 3] > 0.05).mean() > 0.1, "camera misses content"
    share, worst = so.mismatch_share(got, expect)
    assert share <= 0.05, f"{share:.3f} of pixels off, max err {worst}"


@pytest.mark.parametrize("direction", list(so.DIRECTIONS))
def test_smoothing_is_identity_on_constant_volume(direction):
    """A constant grid is its own Gaussian smoothing (masked taps are
    renormalised), whichever axis the march runs along."""
    import jax.numpy as jnp

    from volym import Scene

    sc = Scene(
        volume=jnp.full((so.SIDE,) * 3, 0.5, jnp.float32),
        importance=jnp.zeros((so.SIDE,) * 3, jnp.float32),
        tf_lut=so.scene("base").tf_lut,
    )
    m = so.camera(direction).matrices()
    plain = np.asarray(slab.render(sc, m, so.params("base"), so.RES, so.RES))
    smooth = np.asarray(slab.render(sc, m, so.params("smoothing"), so.RES, so.RES))
    np.testing.assert_allclose(smooth, plain, atol=1e-5)
