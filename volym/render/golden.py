"""Golden reference renderer: a masked fixed-trip-count ``lax.scan`` march.

This is the semantic ground truth for the whole framework (SURVEY.md
section 4): a line-for-line *mathematical* replication of the reference's
ray-march kernel (``shaders/importance_driven_volume_rendering.wgsl:213-330``)
in pure jnp.  It runs on CPU (BASELINE.json config 1: "CPU-runnable ref"),
differentiates end-to-end via autodiff, and every optimised path (custom
VJP, sharded renderers) is tested allclose against it.

Design notes (SIMD-array semantics, SURVEY.md section 7):
- per-lane ``continue``/``break`` divergence becomes whole-array masking;
- the data-dependent ``while`` becomes a static-bound ``scan`` whose body is
  a no-op for finished rays (early termination as masking, not control flow);
- the adaptive step (``wgsl:262-269``) is per-ray carried state;
- the nested look-ahead loops (``wgsl:94-160``) are vectorised over their
  static trip counts.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from volym.config import RenderParams
from volym.ops import interp
from volym.render import rays as rays_mod
from volym.render import shading
from volym.transfer_function import corrected_alpha, lut_sample

# Gaussian smoothing constants (``wgsl:52-56, 255``).
GAUSSIAN_KERNEL_SIZE = 2
GAUSSIAN_STEP = 0.005
GAUSSIAN_SIGMA = 1.5
# Cone look-ahead constants (``wgsl:112-113``).
CONE_SAMPLES = 8
CONE_ANGLE = 0.2
# Importance-driven thresholds (``wgsl:133, 291``).
IMPORTANT_AHEAD_THRESHOLD = 0.5
IMPORTANCE_OPAQUE = 1.0
#: static probe-count cap when ahead-steps travels as a traced value
#: (the reference GUI slider range is 2..25, ``src/gui.rs:239``)
AHEAD_CAP = 25


def sample_density(volume, pos, ray_dir, params: RenderParams, sample_fn):
    """Density sample, optionally Gaussian-smoothed along the ray
    (``wgsl:252-259``; smoothing ``wgsl:44-75``)."""
    if not params.use_gaussian_smoothing:
        return sample_fn(volume, pos)
    total = jnp.zeros(pos.shape[:-1], jnp.float32)
    weight_sum = jnp.zeros(pos.shape[:-1], jnp.float32)
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
        offset = i * GAUSSIAN_STEP
        p = pos + ray_dir * offset
        in_bounds = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
        w = math.exp(-(offset * offset) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA))
        s = sample_fn(volume, p)
        total = total + jnp.where(in_bounds, s * w, 0.0)
        weight_sum = weight_sum + jnp.where(in_bounds, w, 0.0)
    return total / jnp.where(weight_sum > 0.0, weight_sum, 1.0)


def importance_to_color(importance):
    """Heat-map colouring of importance (``wgsl:83-92``).  The green channel
    can exceed 1; the rgba8unorm output clamps on store, which
    :func:`volym.io.to_uint8_image` reproduces."""
    return jnp.stack(
        [
            jnp.minimum(importance * 1.5, 1.0),
            (1.0 - importance) * 1.2,
            jnp.full_like(importance, 0.2),
            importance,
        ],
        axis=-1,
    )


def cone_directions(main_dir):
    """The 8 cone sample directions around ``main_dir`` (``wgsl:94-106``).

    Quirk preserved: ``right = normalize(cross(main, (0,1,0)))`` is
    ill-defined when the ray is vertical; we guard the normalisation with an
    epsilon (the reference would produce NaNs there).
    Returns (..., CONE_SAMPLES, 3).
    """
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.cross(main_dir, jnp.broadcast_to(up, main_dir.shape))
    right = right / jnp.maximum(jnp.linalg.norm(right, axis=-1, keepdims=True), 1e-12)
    new_up = jnp.cross(main_dir, right)
    dirs = []
    for s in range(CONE_SAMPLES):
        angle = (s / CONE_SAMPLES) * 2.0 * 3.14159  # wgsl:99 uses 3.14159
        off = math.cos(angle) * CONE_ANGLE, math.sin(angle) * CONE_ANGLE
        d = main_dir + right * off[0] + new_up * off[1]
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        dirs.append(d)
    return jnp.stack(dirs, axis=-2)


def has_important_ahead_straight(importance_grid, pos, ray_dir, max_distance, check_steps):
    """Straight look-ahead (``wgsl:141-160``).

    Reference quirk preserved: the step length divides
    ``max_distance - length(pos)`` where ``length(pos)`` is the *norm of the
    position* (distance from the world origin), not the distance marched
    along the ray.  No bounds test — the clamp-to-edge sampler handles
    out-of-box positions (``importance.rs:122-131``).
    """
    static_k = isinstance(check_steps, int)
    kcap = check_steps if static_k else AHEAD_CAP
    step = (max_distance - jnp.linalg.norm(pos, axis=-1)) / check_steps  # (R,)
    ks = jnp.arange(1, kcap + 1, dtype=jnp.float32)  # (K,)
    p = pos[..., None, :] + ray_dir[..., None, :] * (step[..., None] * ks)[..., None]
    imp = interp.sample_nearest(importance_grid, p)  # (R, K)
    hits = imp >= IMPORTANT_AHEAD_THRESHOLD
    if not static_k:
        hits = hits & (ks <= check_steps)
    return jnp.any(hits, axis=-1)


def has_important_ahead_cone(importance_grid, pos, ray_dir, max_distance, check_steps):
    """Cone look-ahead: 8 directions, bounds-terminated (``wgsl:108-139``).

    The per-sample ``break`` on leaving the box is equivalent to masking all
    out-of-bounds samples: the box is convex, so in-bounds samples along a
    straight probe form a prefix.
    """
    static_k = isinstance(check_steps, int)
    kcap = check_steps if static_k else AHEAD_CAP
    step = (max_distance - jnp.linalg.norm(pos, axis=-1)) / check_steps  # (R,)
    dirs = cone_directions(ray_dir)  # (R, S, 3)
    ks = jnp.arange(1, kcap + 1, dtype=jnp.float32)  # (K,)
    # (R, S, K, 3)
    p = (
        pos[..., None, None, :]
        + dirs[..., :, None, :] * (step[..., None, None] * ks[None, None, :])[..., None]
    )
    in_bounds = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
    imp = interp.sample_nearest(importance_grid, p)
    hits = in_bounds & (imp >= IMPORTANT_AHEAD_THRESHOLD)
    if not static_k:
        hits = hits & (ks <= check_steps)
    return jnp.any(hits, axis=(-2, -1))


def make_step_fn(scene, origin, directions, exit_, cam_pos, params: RenderParams, dyn=None):
    """Build the per-iteration state update shared by the scan (golden) and
    while_loop (fast) drivers.  State: (t, step, acc_c, acc_a, done).

    ``dyn``: traced knob vector from :meth:`RenderParams.split_dynamic`
    (threshold, step size, early alpha, ahead steps) — the per-frame
    uniform-update analog; ``None`` reads the (static) params floats."""
    sample_fn = interp.make_sampler(params.interpolation)
    if dyn is None:
        threshold = params.density_threshold
        base_step = params.raymarching_step_size
        early_alpha = params.early_termination_alpha
        ahead_steps = params.importance_check_ahead_steps
    else:
        threshold, base_step, early_alpha, ahead_steps = (
            dyn[0], dyn[1], dyn[2], dyn[3],
        )
    min_step = base_step * 0.25
    use_alpha_static = params.use_opacity or params.use_importance_coloring

    def vol_sample(p):
        return sample_fn(scene.volume, p)

    def active_mask(carry):
        t, step, acc_c, acc_a, done = carry
        return (t < exit_) & (acc_a < early_alpha) & ~done

    def step_fn(carry):
        t, step, acc_c, acc_a, done = carry
        active = active_mask(carry)

        pos = origin[None, :] + directions * t[:, None]
        density = sample_density(scene.volume, pos, directions, params, sample_fn)
        importance = interp.sample_nearest(scene.importance, pos)

        # Adaptive step (wgsl:262-269); fixed-step mode for the
        # differentiable path (SURVEY.md section 7 hard part (a)).
        dense = density >= threshold
        if params.adaptive_stepping:
            new_step = jnp.where(dense, min_step, jnp.minimum(base_step, step * 1.5))
        else:
            new_step = jnp.broadcast_to(
                jnp.asarray(base_step, jnp.float32), step.shape
            )

        skip = ~dense  # wgsl:271-274

        if params.use_importance_coloring:
            color_alpha = importance_to_color(importance)
        else:
            if params.use_importance_rendering:
                if params.use_cone_importance_check:
                    ahead = has_important_ahead_cone(
                        scene.importance, pos, directions, exit_, ahead_steps
                    )
                else:
                    ahead = has_important_ahead_straight(
                        scene.importance, pos, directions, exit_, ahead_steps
                    )
                skip = skip | ((importance < IMPORTANCE_OPAQUE) & ahead)  # wgsl:291-294
            color_alpha = lut_sample(scene.tf_lut, density)  # wgsl:297-303

        if params.use_shading:
            shaded = shading.blinn_phong(vol_sample, pos, color_alpha[..., :3], cam_pos)
        else:
            shaded = color_alpha[..., :3]

        contribute = active & ~skip
        if use_alpha_static:
            alpha = corrected_alpha(color_alpha[..., 3], new_step * 100.0)
            contrib = (1.0 - acc_a) * alpha * contribute
            acc_c = acc_c + shaded * contrib[:, None]
            acc_a = acc_a + contrib
        else:
            # wgsl:319-323 — first contributing sample wins, then break.
            acc_c = jnp.where(contribute[:, None], shaded, acc_c)
            acc_a = jnp.where(contribute, 1.0, acc_a)
            done = done | contribute

        t = jnp.where(active, t + new_step, t)
        step = jnp.where(active, new_step, step)
        return (t, step, acc_c, acc_a, done)

    return step_fn, active_mask


def init_state(entry, params: RenderParams, base_step=None):
    r = entry.shape[0]
    step0 = params.raymarching_step_size if base_step is None else base_step
    return (
        entry,
        jnp.broadcast_to(jnp.asarray(step0, jnp.float32), (r,)),
        jnp.zeros((r, 3), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), bool),
    )


def march(scene, origin, directions, entry, exit_, cam_pos, params: RenderParams):
    """Front-to-back masked march of all rays at once (``wgsl:243-326``).

    Args:
      scene: :class:`volym.scene.Scene` pytree.
      origin: (3,) shared ray origin.
      directions: (R, 3) unit ray directions.
      entry, exit_: (R,) slab parameters.
    Returns:
      (R, 4) accumulated RGBA.
    """
    num_steps = params.resolved_max_steps()
    step_fn, _ = make_step_fn(scene, origin, directions, exit_, cam_pos, params)
    (t, step, acc_c, acc_a, done), _ = jax.lax.scan(
        lambda c, _: (step_fn(c), None), init_state(entry, params), None, length=num_steps
    )
    return jnp.concatenate([acc_c, acc_a[:, None]], axis=-1)


@partial(jax.jit, static_argnames=("params", "height", "width"))
def render(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Render an (H, W, 4) float RGBA image (``wgsl:213-330`` end to end).

    Misses paint (0, 0, 0, 1) like ``wgsl:238-241``.
    """
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march(scene, origin, dirs, entry, exit_, camera_matrices.position, params)
    miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    img = jnp.where(miss[:, None], miss_color[None, :], img)
    return img.reshape(height, width, 4)
