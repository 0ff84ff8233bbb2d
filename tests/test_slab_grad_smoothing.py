"""The gradient rule of the slab march, continued: coloring with shading
and Gaussian smoothing (plain and shaded, chained through the stencil),
each with trilinear and nearest sampling, along all six directions."""

import pytest

import slab_oracle as so
from test_slab_grad_modes import replay_vs_autodiff


@pytest.mark.parametrize("direction", list(so.DIRECTIONS))
@pytest.mark.parametrize("interpolation", so.INTERPOLATIONS)
@pytest.mark.parametrize("mode", ["coloring_shading", "smoothing", "smoothing_shading"])
def test_replay_vjp_matches_autodiff(mode, interpolation, direction):
    replay_vs_autodiff(mode, interpolation, direction)
