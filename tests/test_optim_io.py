"""Inverse-rendering fit and IO tests."""

import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym import io as vio
from volym.optim import fit_scene
from volym.render import golden

PARAMS = RenderParams(
    use_gaussian_smoothing=False,
    adaptive_stepping=False,
    raymarching_step_size=0.1,
    interpolation="trilinear",
    use_shading=False,
    max_steps=20,
)

# Well-conditioned inverse problem: no density-threshold cliff (threshold 0
# makes every sample differentiable), moderate per-sample opacity so
# gradients reach past the front voxels, no early saturation.
FIT_PARAMS = PARAMS.replace(
    density_threshold=0.0, raymarching_step_size=0.05, max_steps=40
)


def test_fit_volume_reduces_loss():
    import jax.numpy as jnp

    side, res = 12, 8
    target_scene = Scene.synthetic("sphere", side=side)
    cam = Camera(aspect=1.0, distance=1.1).orbit(15.0, 10.0, 0.0)
    target = golden.render(target_scene, cam.matrices(), FIT_PARAMS, res, res)

    init = Scene(
        volume=jnp.full_like(target_scene.volume, 0.2),
        importance=target_scene.importance,
        tf_lut=target_scene.tf_lut,
    )
    res_fit = fit_scene(
        init, cam.matrices(), target, FIT_PARAMS, steps=40, learning_rate=5e-2,
        optimize=("volume",),
    )
    assert res_fit.losses[-1] < res_fit.losses[0] * 0.5, res_fit.losses[:3] + res_fit.losses[-3:]
    v = np.asarray(res_fit.scene.volume)
    assert v.min() >= 0.0 and v.max() <= 1.0  # projection keeps r8unorm range


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((8, 6, 4)).astype(np.float32)
    p = tmp_path / "img.png"
    vio.write_png(p, img)
    from PIL import Image

    back = np.asarray(Image.open(p))
    assert back.shape == (8, 6, 4)
    np.testing.assert_allclose(back, vio.to_uint8_image(img), atol=0)


def test_uint8_conversion_clamps():
    img = np.array([[[-0.5, 0.5, 1.5, 1.0]]], np.float32)
    out = vio.to_uint8_image(img)
    assert out.tolist() == [[[0, 128, 255, 255]]]


def test_checkpoint_roundtrip(tmp_path):
    p = tmp_path / "ckpt.npz"
    vio.save_checkpoint(p, {"volume": np.ones((2, 2, 2)), "tf_lut": np.zeros((4, 4))})
    back = vio.load_checkpoint(p)
    assert set(back) == {"volume", "tf_lut"}
    assert back["volume"].sum() == 8


def test_screenshot_naming(tmp_path):
    path = vio.save_screenshot(np.zeros((4, 4, 4), np.float32), tmp_path)
    assert path.name.startswith("screenshot_") and path.suffix == ".png"
    assert path.exists()
