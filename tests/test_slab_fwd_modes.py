"""Slab forward vs the NumPy oracle: base, first-hit, coloring and shading,
each with trilinear and nearest sampling, marching along all six axis
directions."""

import numpy as np
import pytest

import slab_oracle as so
from volym.render import slab


@pytest.mark.parametrize("direction", list(so.DIRECTIONS))
@pytest.mark.parametrize("interpolation", so.INTERPOLATIONS)
@pytest.mark.parametrize("mode", ["base", "first_hit", "coloring", "shading"])
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
