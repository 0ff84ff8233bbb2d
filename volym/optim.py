"""Inverse rendering: fit scene parameters to target images.

The payoff of the differentiable mode (BASELINE.json config 4): optimise
voxel densities, the TF LUT, and/or the camera pose against rendered
targets.  No reference counterpart — the reference is forward-only — but
this is what the custom VJP exists for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from volym.config import RenderParams
from volym.render import diff
from volym.scene import Scene


@dataclass
class FitResult:
    scene: Scene
    losses: list[float]


def l2_image_loss(img, target):
    return jnp.mean((img - target) ** 2)


def fit_scene(
    scene: Scene,
    camera_matrices,
    target,
    params: RenderParams,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    optimize: tuple[str, ...] = ("volume", "tf_lut"),
    loss_fn: Callable = l2_image_loss,
    callback=None,
) -> FitResult:
    """Gradient-descend selected scene leaves to match ``target`` (H, W, 4).

    Voxel densities and LUT entries are kept in [0, 1] by projection after
    each update (the r8unorm range)."""
    height, width = target.shape[:2]
    target = jnp.asarray(target)
    opt = optax.adam(learning_rate)

    trainable = {k: getattr(scene, k) for k in optimize}
    frozen = {
        k: getattr(scene, k) for k in ("volume", "importance", "tf_lut") if k not in optimize
    }
    opt_state = opt.init(trainable)

    @jax.jit
    def step(trainable, opt_state):
        def loss_of(tr):
            s = Scene(**{**frozen, **tr})
            img = diff.render(s, camera_matrices, params, height, width)
            return loss_fn(img, target)

        loss, grads = jax.value_and_grad(loss_of)(trainable)
        updates, opt_state = opt.update(grads, opt_state)
        trainable = optax.apply_updates(trainable, updates)
        trainable = jax.tree_util.tree_map(lambda x: jnp.clip(x, 0.0, 1.0), trainable)
        return trainable, opt_state, loss

    losses = []
    for i in range(steps):
        trainable, opt_state, loss = step(trainable, opt_state)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    return FitResult(scene=Scene(**{**frozen, **trainable}), losses=losses)
