"""Debug visualisations.

Analogs of the reference's shader-debug machinery:

- :func:`importance_debug` — the ``importance_test.wgsl`` smoke kernel
  (``shaders/importance_test.wgsl:42-104``): one sample at the ray-box
  midpoint, red where importance > 0.5, blue where dense but unimportant,
  black elsewhere.
- :func:`debug_matrix` — the writable debug texture (component 12,
  ``src/gpu_resources/debug_matrix.rs``) as the legacy ``.bak`` kernel used
  it (``shaders/simple_compute.wgsl.bak:184-185``): ray directions as RGB,
  plus a step-count heat channel (useful for early-termination tuning; the
  reference had no step-count view).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from volym.config import RenderParams
from volym.ops import interp
from volym.render import golden
from volym.render import rays as rays_mod

DENSITY_AIR_THRESHOLD = 0.1  # importance_test.wgsl:84
IMPORTANCE_SPLIT = 0.5  # importance_test.wgsl:95


@partial(jax.jit, static_argnames=("height", "width"))
def importance_debug(scene, camera_matrices, height: int, width: int):
    """Red/blue midpoint importance check (``importance_test.wgsl``)."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry

    mid = origin[None, :] + dirs * ((entry + exit_) * 0.5)[:, None]
    density = interp.sample_nearest(scene.volume, mid)
    importance = interp.sample_nearest(scene.importance, mid)

    red = jnp.array([1.0, 0.0, 0.0, 1.0], jnp.float32)
    blue = jnp.array([0.0, 0.0, 1.0, 1.0], jnp.float32)
    black = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)

    col = jnp.where(
        (importance > IMPORTANCE_SPLIT)[:, None], red[None, :], blue[None, :]
    )
    col = jnp.where((density > DENSITY_AIR_THRESHOLD)[:, None], col, black[None, :])
    col = jnp.where(miss[:, None], black[None, :], col)
    return col.reshape(height, width, 4)


@partial(jax.jit, static_argnames=("params", "height", "width"))
def debug_matrix(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Ray-direction RGB (legacy kernel's debug write) + normalised
    march-step-count in alpha."""
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)

    step_fn, active_mask = golden.make_step_fn(
        scene, origin, dirs, exit_, camera_matrices.position, params
    )
    num_steps = params.resolved_max_steps()

    def body(carry, _):
        state, count = carry
        active = active_mask(state)
        return (step_fn(state), count + active), None

    r = dirs.shape[0]
    (state, count), _ = jax.lax.scan(
        body,
        (golden.init_state(entry, params), jnp.zeros((r,), jnp.int32)),
        None,
        length=num_steps,
    )
    dir_rgb = dirs * 0.5 + 0.5  # like writing ray_direction to the debug texture
    heat = count.astype(jnp.float32) / num_steps
    return jnp.concatenate([dir_rgb, heat[:, None]], axis=-1).reshape(height, width, 4)


def step_counts(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Per-ray march iteration counts (the data behind debug_matrix's heat
    channel) as an (H, W) int array."""
    img = debug_matrix(scene, camera_matrices, params, height, width)
    num_steps = params.resolved_max_steps()
    return (jnp.round(img[..., 3] * num_steps)).astype(jnp.int32)


def step_count_histogram(scene, camera_matrices, params: RenderParams, height: int, width: int, bins: int = 16):
    """March-length histogram (SURVEY.md section 5 observability): how many
    rays terminate after how many iterations — the early-termination /
    empty-space-skipping effectiveness view the reference lacked.

    Returns (edges, counts) numpy arrays."""
    import numpy as np

    counts = np.asarray(step_counts(scene, camera_matrices, params, height, width))
    hist, edges = np.histogram(counts, bins=bins, range=(0, params.resolved_max_steps()))
    return edges, hist
