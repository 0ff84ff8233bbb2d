"""The slab path on a GPU against the same function on the host's CPU, at a
small size.  Marked ``gpu``: skipped on the CPU; run on a GPU machine with
``VOLYM_TEST_GPU=1 python -m pytest -m gpu tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym.render import slab

PARAMS = RenderParams(
    density_threshold=0.15, raymarching_step_size=0.02, use_gaussian_smoothing=False,
    interpolation="trilinear", adaptive_stepping=False,
)
SIDE, RES = 64, 64


def _on(dev, fn, *args):
    with jax.default_device(dev), jax.default_matmul_precision("highest"):
        return jax.block_until_ready(fn(*jax.device_put(args, dev)))


@pytest.mark.gpu
@pytest.mark.parametrize("shading", [False, True])
def test_slab_forward_gpu_matches_cpu(gpu_device, shading):
    sc = Scene.synthetic("bonsai", side=SIDE)
    m = Camera(aspect=1.0, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()
    p = PARAMS.replace(use_shading=shading)
    fn = lambda s: slab.render(s, m, p, RES, RES)
    got = np.asarray(_on(gpu_device, fn, sc))
    ref = np.asarray(_on(jax.devices("cpu")[0], fn, sc))
    err = np.abs(got - ref).max(-1)
    assert (err > 2e-3).mean() <= 0.01, f"max err {err.max()}"


@pytest.mark.gpu
def test_slab_grad_gpu_matches_cpu(gpu_device):
    sc = Scene.synthetic("bonsai", side=SIDE)
    m = Camera(aspect=1.0, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()

    def loss(vol, lut):
        return jnp.sum(slab.render_diff(Scene(vol, sc.importance, lut), m, PARAMS, RES, RES))

    g = jax.grad(loss, argnums=(0, 1))
    got = _on(gpu_device, g, sc.volume, sc.tf_lut)
    ref = _on(jax.devices("cpu")[0], g, sc.volume, sc.tf_lut)
    for a, b in zip(got, ref):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 2e-2
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999
