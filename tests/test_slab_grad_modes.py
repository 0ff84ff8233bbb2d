"""The gradient rule of the slab march: ``slab.render_diff``'s replay VJP
equals ``jax.grad`` through the plain forward (``slab.render``), for the
base, coloring and shading modes, each with trilinear and nearest
sampling, marching along all six axis directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import slab_oracle as so
from volym.render import slab
from volym.scene import Scene

LEAVES = ("volume", "importance", "tf_lut")


def replay_vs_autodiff(mode, interpolation, direction):
    sc = so.scene(mode)
    m = so.camera(direction).matrices()
    p = so.params(mode, interpolation)
    wvec = jnp.cos(jnp.arange(so.RES * so.RES * 4, dtype=jnp.float32).reshape(so.RES, so.RES, 4) * 0.1)

    def loss(render, vol, imp, lut):
        return jnp.sum(render(Scene(vol, imp, lut), m, p, so.RES, so.RES) * wvec)

    args = (sc.volume, sc.importance, sc.tf_lut)
    g_auto = jax.grad(lambda *a: loss(slab.render, *a), argnums=(0, 1, 2))(*args)
    g_replay = jax.grad(lambda *a: loss(slab.render_diff, *a), argnums=(0, 1, 2))(*args)
    for name, a, b in zip(LEAVES, g_auto, g_replay):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=3e-3 * scale, rtol=2e-2, err_msg=name)
    # the leaf that carries the colour has a live gradient
    live = 1 if p.use_importance_coloring else 0
    assert np.abs(np.asarray(g_auto[live])).max() > 0


@pytest.mark.parametrize("direction", list(so.DIRECTIONS))
@pytest.mark.parametrize("interpolation", so.INTERPOLATIONS)
@pytest.mark.parametrize("mode", ["base", "coloring", "shading"])
def test_replay_vjp_matches_autodiff(mode, interpolation, direction):
    replay_vs_autodiff(mode, interpolation, direction)
