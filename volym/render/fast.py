"""Fast inference renderer: data-dependent early exit + traced knobs.

Same per-step math as the golden renderer (shared ``make_step_fn``), but the
static-trip-count scan becomes a ``lax.while_loop`` that stops as soon as
every ray has terminated (left the box, hit the alpha>=0.95 early-out, or
first-hit ``break``).  This recovers the reference kernel's data-dependent
march length (``wgsl:250``) at whole-grid granularity: a frame whose rays
all terminate after 120 steps costs 120 iterations, not the 693-step worst
case.  The loop condition is a single on-device ``any`` reduction.

The float knobs (density threshold, step size, early-termination alpha,
ahead steps) travel as a TRACED vector (:meth:`RenderParams.split_dynamic`)
and the iteration bound is derived from the traced step size, so the whole
reference benchmark sweep — and live GUI-style parameter mutation — reuses
ONE compilation per boolean-flag combination (the per-frame uniform-update
analog of ``src/gpu_resources/parameters.rs:68-83``).

Iterations run in blocks of ``EXIT_CHECK_EVERY`` steps between condition
checks to amortise the while_loop's per-iteration condition check (a
device-to-host round trip of the loop predicate on the GPU).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from volym.config import RenderParams
from volym.render import golden
from volym.render import rays as rays_mod

#: Steps per while_loop iteration (condition-check granularity).
EXIT_CHECK_EVERY = 8


def march(scene, origin, directions, entry, exit_, cam_pos, params: RenderParams, dyn=None):
    """While-loop march: identical output to :func:`golden.march`.

    With ``dyn`` the iteration bound is computed from the traced step size
    (worst case: the unit-box diagonal at the minimum step), so changing
    the step size does not retrace."""
    step_fn, active_mask = golden.make_step_fn(
        scene, origin, directions, exit_, cam_pos, params, dyn=dyn
    )
    block = EXIT_CHECK_EVERY
    if dyn is None:
        num_steps = params.resolved_max_steps()
        block = max(1, min(block, num_steps))
        num_blocks = jnp.int32(-(-num_steps // block))
        base_step = None
    else:
        base_step = dyn[1]
        min_step = base_step * (0.25 if params.adaptive_stepping else 1.0)
        if params.max_steps is not None:
            num_steps = jnp.int32(params.max_steps)
        else:
            num_steps = (
                jnp.ceil(jnp.sqrt(3.0) / jnp.maximum(min_step, 1e-6)).astype(
                    jnp.int32
                )
                + 2
            )
        num_blocks = -(-num_steps // block)

    def cond(state):
        k, carry = state
        return (k < num_blocks) & jnp.any(active_mask(carry))

    def body(state):
        k, carry = state
        for _ in range(block):
            carry = step_fn(carry)
        return (k + 1, carry)

    # A finished-ray iteration is a no-op by construction (masked updates),
    # so running up to ``block - 1`` extra steps past termination is safe.
    _, (t, step, acc_c, acc_a, done) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), golden.init_state(entry, params, base_step))
    )
    return jnp.concatenate([acc_c, acc_a[:, None]], axis=-1)


@partial(jax.jit, static_argnames=("params", "height", "width"))
def _render_jit(scene, camera_matrices, dyn, params, height, width):
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march(
        scene, origin, dirs, entry, exit_, camera_matrices.position, params,
        dyn=dyn,
    )
    miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    img = jnp.where(miss[:, None], miss_color[None, :], img)
    return img.reshape(height, width, 4)


def render(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Fast full-frame render -> (H, W, 4); bit-compatible with golden."""
    static, dyn = params.split_dynamic()
    return _render_jit(scene, camera_matrices, dyn, static, height, width)
