"""Differentiable renderer: fixed-step march with a memory-free custom VJP.

BASELINE.json's differentiable mode: gradients w.r.t. voxel densities, the
transfer-function LUT, and the camera pose, "propagated through
early-ray-termination via saved per-step transmittance".  We go one better
than saving per-step transmittance (O(rays * steps) memory): the compositing
recurrence is *invertible in the forward direction*, so the backward pass
replays the march front-to-back, reconstructing the per-step transmittance
``T_k = 1 - acc_a_k`` from the running accumulator and obtaining the suffix
sums it needs from the (saved) final image:

    acc_c = sum_k w_k c_k,  w_k = T_k beta_k,  T_k = prod_{j<k}(1 - beta_j)

    dL/dc_k    = g_c * w_k
    dL/dbeta_k = T_k (g_c . c_k + g_a)
                 - (g_c . S_c^{>k} + g_a S_a^{>k}) / (1 - beta_k)

with ``S^{>k} = final - prefix_{<=k}`` — O(rays) memory total, one extra
forward-cost sweep.

Bandwidth structure of the backward (the production concern): the volume
only enters each step through its *tap samples* — the march samples at a
static set of tap positions per step (density taps, optionally Gaussian
offsets along the ray and central-difference shading offsets).  The step
computation is therefore factored as ``taps -> samples -> quantities``;
``jax.vjp`` machine-derives the (samples, lut, imp, pos) cotangents of the
small ``quantities`` function, and the sample cotangents are hand-scattered
into a gradient grid *carried through the scan* —
``interp.scatter_*_into`` — so no step ever materialises or adds a full
(D, H, W) array.  Tap-position cotangents are chained to (origin, dirs,
entry) analytically (the taps are affine in them).

Discrete decisions (density threshold, early termination, importance
look-ahead skip) are treated as constants of the backward pass — the
standard straight-through choice for volume rendering; they are recomputed
bit-identically during the replay because the replay *is* the forward
recurrence.

The adaptive step (``wgsl:262-269``) is forward-only; this path fixes the
step size so sample positions are an affine function of (entry, k), which is
what makes camera gradients well-defined (SURVEY.md section 7 hard part (a)).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from volym.config import Interpolation, RenderParams
from volym.ops import interp
from volym.render import rays as rays_mod
from volym.render import shading
from volym.render.golden import (
    GAUSSIAN_KERNEL_SIZE,
    GAUSSIAN_SIGMA,
    GAUSSIAN_STEP,
    IMPORTANCE_OPAQUE,
    has_important_ahead_cone,
    has_important_ahead_straight,
    importance_to_color,
)
from volym.transfer_function import corrected_alpha, lut_sample

_EPS_ONE_MINUS_BETA = 1e-7


# ----------------------------------------------------------------------
# Tap structure: every volume access of one march step, as a static list.
# ----------------------------------------------------------------------


def _tap_spec(params: RenderParams):
    """Static tap description.

    Returns (ray_offsets, axis_offsets) where taps are
      ``pos + dirs * ray_offsets[i]``                      (density taps)
      followed by ``pos + axis_offsets[j]``                (shading taps).
    """
    if params.use_gaussian_smoothing:
        ray_offsets = [i * GAUSSIAN_STEP for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1)]
    else:
        ray_offsets = [0.0]
    axis_offsets = []
    if params.use_shading:
        eps = shading.GRADIENT_OFFSET
        for axis in range(3):
            for sign in (1.0, -1.0):
                off = [0.0, 0.0, 0.0]
                off[axis] = sign * eps
                axis_offsets.append(off)
    return ray_offsets, axis_offsets


def _tap_positions(params: RenderParams, pos, dirs):
    """(R, T, 3) tap positions for a step at ray positions ``pos``."""
    ray_offsets, axis_offsets = _tap_spec(params)
    taps = [pos + dirs * off for off in ray_offsets]
    taps += [pos + jnp.asarray(off, jnp.float32)[None, :] for off in axis_offsets]
    return jnp.stack(taps, axis=1)


def _quantities_from_samples(params: RenderParams, samples, imp, lut, pos, dirs, cam_pos):
    """Per-step march quantities from tap samples (``wgsl:251-314`` minus
    control flow and texture fetches).

    Args:
      samples: (R, T) tap samples in tap-spec order.
    Returns:
      (shaded (R,3), alpha (R,), density (R,)).
    """
    ray_offsets, axis_offsets = _tap_spec(params)
    n_density = len(ray_offsets)

    if params.use_gaussian_smoothing:
        total = jnp.zeros(samples.shape[:1], jnp.float32)
        weight_sum = jnp.zeros(samples.shape[:1], jnp.float32)
        for i, off in enumerate(ray_offsets):
            p = pos + dirs * off
            in_bounds = jnp.all((p >= 0.0) & (p <= 1.0), axis=-1)
            wgt = math.exp(-(off * off) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA))
            total = total + jnp.where(in_bounds, samples[:, i] * wgt, 0.0)
            weight_sum = weight_sum + jnp.where(in_bounds, wgt, 0.0)
        density = total / jnp.where(weight_sum > 0.0, weight_sum, 1.0)
    else:
        density = samples[:, 0]

    if params.use_importance_coloring:
        color_alpha = importance_to_color(imp)
    else:
        color_alpha = lut_sample(lut, density)

    if params.use_shading:
        eps = shading.GRADIENT_OFFSET
        grads = []
        for axis in range(3):
            hi = samples[:, n_density + 2 * axis]
            lo = samples[:, n_density + 2 * axis + 1]
            grads.append((hi - lo) / (2.0 * eps))
        g = jnp.stack(grads, axis=-1)
        shaded = shading.blinn_phong_from_gradient(g, pos, color_alpha[..., :3], cam_pos)
    else:
        shaded = color_alpha[..., :3]

    step = params.raymarching_step_size
    alpha = corrected_alpha(color_alpha[..., 3], jnp.float32(step * 100.0))
    return shaded, alpha, density


def _contribute_mask(params: RenderParams, importance_grid, density, imp, pos, dirs, t, exit_, acc_a):
    """The non-differentiable march decisions, recomputed identically in the
    forward and replay sweeps."""
    active = (t < exit_) & (acc_a < params.early_termination_alpha)
    dense = density >= params.density_threshold
    skip = ~dense
    if params.use_importance_rendering and not params.use_importance_coloring:
        if params.use_cone_importance_check:
            ahead = has_important_ahead_cone(
                importance_grid, pos, dirs, exit_, params.importance_check_ahead_steps
            )
        else:
            ahead = has_important_ahead_straight(
                importance_grid, pos, dirs, exit_, params.importance_check_ahead_steps
            )
        skip = skip | ((imp < IMPORTANCE_OPAQUE) & ahead)
    return active & ~skip


def _step_inputs(params, volume, importance, origin, dirs, entry, k):
    sample_fn = interp.make_sampler(params.interpolation)
    t = entry + k * jnp.float32(params.raymarching_step_size)
    pos = origin[None, :] + dirs * t[:, None]
    taps = _tap_positions(params, pos, dirs)
    samples = sample_fn(volume, taps)
    imp = interp.sample_nearest(importance, pos)
    return t, pos, taps, samples, imp


def _march_scan(params: RenderParams, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
    """Forward fixed-step march (primal)."""
    num_steps = params.resolved_max_steps()

    def body(carry, k):
        acc_c, acc_a = carry
        t, pos, _taps, samples, imp = _step_inputs(
            params, volume, importance, origin, dirs, entry, k
        )
        shaded, alpha, density = _quantities_from_samples(
            params, samples, imp, lut, pos, dirs, cam_pos
        )
        m = _contribute_mask(
            params, importance, density, imp, pos, dirs, t, exit_, acc_a
        )
        beta = alpha * m
        w = (1.0 - acc_a) * beta
        acc_c = acc_c + shaded * w[:, None]
        acc_a = acc_a + w
        return (acc_c, acc_a), None

    r = dirs.shape[0]
    init = (jnp.zeros((r, 3), jnp.float32), jnp.zeros((r,), jnp.float32))
    (acc_c, acc_a), _ = jax.lax.scan(
        body, init, jnp.arange(num_steps, dtype=jnp.float32)
    )
    return jnp.concatenate([acc_c, acc_a[:, None]], axis=-1)


@partial(jax.custom_vjp, nondiff_argnums=(0,))
def march_fixed(params: RenderParams, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
    """Fixed-step differentiable march of R rays -> (R, 4) RGBA."""
    return _march_scan(params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos)


def _march_fwd(params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos):
    img = _march_scan(params, volume, importance, lut, origin, dirs, entry, exit_, cam_pos)
    return img, (volume, importance, lut, origin, dirs, entry, exit_, cam_pos, img)


def _march_bwd(params: RenderParams, res, g):
    volume, importance, lut, origin, dirs, entry, exit_, cam_pos, img = res
    g_c, g_a = g[:, :3], g[:, 3]
    fin_c, fin_a = img[:, :3], img[:, 3]
    num_steps = params.resolved_max_steps()
    sample_fn = interp.make_sampler(params.interpolation)
    scatter_into = interp.make_scatter_into(params.interpolation)
    trilinear = params.interpolation == Interpolation.TRILINEAR
    ray_offsets, axis_offsets = _tap_spec(params)
    tap_ray_off = jnp.asarray(
        ray_offsets + [0.0] * len(axis_offsets), jnp.float32
    )  # per-tap d(tap)/d(dirs) scale

    def body(carry, k):
        acc_c, acc_a, dvol, dimp, dlut, dorigin, ddirs, dentry, dcam = carry
        t, pos, taps, samples, imp = _step_inputs(
            params, volume, importance, origin, dirs, entry, k
        )

        def f(samples_, imp_, lut_, pos_, dirs_, cam_pos_):
            shaded, alpha, density = _quantities_from_samples(
                params, samples_, imp_, lut_, pos_, dirs_, cam_pos_
            )
            return (shaded, alpha), density

        ((shaded, alpha), density), fvjp = jax.vjp(
            f, samples, imp, lut, pos, dirs, cam_pos, has_aux=False
        )
        # jax.vjp without has_aux: f returns ((shaded, alpha), density); we
        # need cotangents for all outputs — density cotangent is zero.
        m = _contribute_mask(
            params, importance, density, imp, pos, dirs, t, exit_, acc_a
        )
        beta = alpha * m
        t_k = 1.0 - acc_a  # prefix transmittance, reconstructed
        w = t_k * beta

        new_acc_c = acc_c + shaded * w[:, None]
        new_acc_a = acc_a + w
        suf_c = fin_c - new_acc_c  # S_c^{>k}
        suf_a = fin_a - new_acc_a  # S_a^{>k}

        d_c = g_c * w[:, None]
        inv = 1.0 / jnp.maximum(1.0 - beta, _EPS_ONE_MINUS_BETA)
        d_beta = (
            t_k * (jnp.sum(g_c * shaded, axis=-1) + g_a)
            - (jnp.sum(g_c * suf_c, axis=-1) + g_a * suf_a) * inv
        )
        d_alpha = jnp.where(m, d_beta, 0.0)

        dsamples, dimp_s, dlut_g, dpos_h, ddirs_h, dcam_g = fvjp(
            ((d_c, d_alpha), jnp.zeros_like(density))
        )

        # volume / importance grads: scatter into the carried grids
        dvol = scatter_into(dvol, taps, dsamples)
        dimp = scatter_nearest(dimp, pos, dimp_s)
        dlut = dlut + dlut_g

        # position grads through the sampling itself (trilinear only;
        # nearest sampling is piecewise constant in position)
        if trilinear:
            _, svjp = jax.vjp(lambda taps_: sample_fn(volume, taps_), taps)
            (dtaps,) = svjp(dsamples)
        else:
            dtaps = jnp.zeros_like(taps)

        # chain tap cotangents to (pos, dirs): tap = pos + dirs*off_ray + const
        dpos = dpos_h + jnp.sum(dtaps, axis=1)
        ddirs_step = ddirs_h + jnp.sum(dtaps * tap_ray_off[None, :, None], axis=1)

        # pos = origin + dirs * t, t = entry + k*step
        dorigin = dorigin + jnp.sum(dpos, axis=0)
        ddirs = ddirs + dpos * t[:, None] + ddirs_step
        dentry = dentry + jnp.sum(dpos * dirs, axis=-1)
        dcam = dcam + dcam_g

        return (new_acc_c, new_acc_a, dvol, dimp, dlut, dorigin, ddirs, dentry, dcam), None

    r = dirs.shape[0]
    init = (
        jnp.zeros((r, 3), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros_like(volume),
        jnp.zeros_like(importance),
        jnp.zeros_like(lut),
        jnp.zeros_like(origin),
        jnp.zeros_like(dirs),
        jnp.zeros_like(entry),
        jnp.zeros_like(cam_pos),
    )
    (_, _, dvol, dimp, dlut, dorigin, ddirs, dentry, dcam), _ = jax.lax.scan(
        body, init, jnp.arange(num_steps, dtype=jnp.float32)
    )
    d_exit = jnp.zeros_like(exit_)  # enters through masks only
    return (dvol, dimp, dlut, dorigin, ddirs, dentry, d_exit, dcam)


def scatter_nearest(acc, pos, g):
    return interp.scatter_nearest_into(acc, pos, g)


march_fixed.defvjp(_march_fwd, _march_bwd)


@partial(jax.jit, static_argnames=("params", "height", "width"))
def render(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Differentiable render -> (H, W, 4).

    Like :func:`volym.render.golden.render` but fixed-step with the
    custom replay VJP.  ``jax.grad`` of any scalar of the output propagates
    to ``scene.volume`` / ``scene.importance`` / ``scene.tf_lut`` and to the
    camera matrices/position (use trilinear interpolation for non-trivial
    position gradients).
    """
    if not (params.use_opacity or params.use_importance_coloring):
        raise NotImplementedError(
            "the first-hit (use_opacity=False) mode is piecewise constant; "
            "use the golden renderer for it"
        )
    params = params.replace(adaptive_stepping=False)
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march_fixed(
        params,
        scene.volume,
        scene.importance,
        scene.tf_lut,
        origin,
        dirs,
        entry,
        jax.lax.stop_gradient(exit_),
        camera_matrices.position,
    )
    miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    img = jnp.where(miss[:, None], miss_color[None, :], img)
    return img.reshape(height, width, 4)
