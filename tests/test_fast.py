"""Fast (while_loop early-exit) renderer must match golden bit-for-bit-ish."""

import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym.render import fast, golden

RES = 16


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("teapot", side=16)


@pytest.fixture(scope="module")
def cam():
    return Camera(aspect=1.0, distance=1.1).orbit(30.0, 20.0, 0.0)


@pytest.mark.parametrize(
    "params",
    [
        RenderParams(use_gaussian_smoothing=False, raymarching_step_size=0.05),
        RenderParams(use_gaussian_smoothing=False, raymarching_step_size=0.05, use_opacity=False),
        RenderParams(
            use_gaussian_smoothing=False,
            raymarching_step_size=0.05,
            use_importance_rendering=True,
            importance_check_ahead_steps=4,
        ),
        RenderParams(raymarching_step_size=0.05, interpolation="trilinear"),
    ],
    ids=["base", "first_hit", "importance", "trilinear_gauss"],
)
def test_fast_matches_golden(scene, cam, params):
    m = cam.matrices()
    a = np.asarray(golden.render(scene, m, params, RES, RES))
    b = np.asarray(fast.render(scene, m, params, RES, RES))
    assert (a[..., :3].max(-1) > 0.01).mean() > 0.1
    np.testing.assert_allclose(b, a, atol=1e-6)
