"""Debug visualiser tests (reference importance_test.wgsl + debug matrix)."""

import numpy as np

from volym import Camera, RenderParams, Scene
from volym.render import debug_vis


def test_importance_debug_colors():
    scene = Scene.synthetic("teapot", side=16)
    cam = Camera(aspect=1.0, distance=1.1).orbit(30.0, 20.0, 0.0)
    img = np.asarray(debug_vis.importance_debug(scene, cam.matrices(), 16, 16))
    assert img.shape == (16, 16, 4)
    # every pixel is exactly red, blue, or black (importance_test.wgsl:84-99)
    allowed = {(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)}
    seen = {tuple(px) for px in img[..., :3].reshape(-1, 3).tolist()}
    assert seen <= allowed
    assert (img[..., 3] == 1.0).all()
    assert len(seen) >= 2  # scene has both air and content


def test_debug_matrix_channels():
    scene = Scene.synthetic("sphere", side=16)
    cam = Camera(aspect=1.0, distance=1.1).orbit(10.0, 5.0, 0.0)
    params = RenderParams(
        use_gaussian_smoothing=False, raymarching_step_size=0.1, max_steps=24
    )
    img = np.asarray(debug_vis.debug_matrix(scene, cam.matrices(), params, 8, 8))
    assert img.shape == (8, 8, 4)
    # RGB encodes unit ray directions mapped to [0,1]
    assert (img[..., :3] >= 0).all() and (img[..., :3] <= 1).all()
    # step-count heat: rays through the box take more steps than misses
    assert img[..., 3].max() > 0
    assert img[..., 3].max() <= 1.0


def test_step_count_histogram():
    scene = Scene.synthetic("sphere", side=16)
    cam = Camera(aspect=1.0, distance=1.1).orbit(30.0, 20.0, 0.0)
    params = RenderParams(
        use_gaussian_smoothing=False, raymarching_step_size=0.1,
        max_steps=32, use_shading=False,
    )
    edges, hist = debug_vis.step_count_histogram(
        scene, cam.matrices(), params, 8, 8, bins=8
    )
    assert hist.sum() == 64  # every ray lands in a bucket
    assert len(edges) == 9
    assert hist[1:].sum() > 0  # some rays actually march
