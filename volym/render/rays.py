"""Ray generation and ray-box intersection.

Replicates the per-pixel setup of the reference kernel:

- screen->NDC mapping (``wgsl:221-229``): ``u = x/W`` (no half-pixel
  offset), ``ndc = (2u-1, 1-2v)``;
- unprojection through ``inverse_view_proj`` at NDC z=0 (``wgsl:231-234``);
- slab intersection against the unit box [0,1]^3 with entry/exit clamped to
  >= 0 (``wgsl:162-179``).

All functions are jnp, shape-polymorphic over a leading ray axis, and
differentiable w.r.t. the camera matrices/position.
"""

from __future__ import annotations

import jax.numpy as jnp


def pixel_ndc(height: int, width: int):
    """NDC coords for every pixel, matching ``wgsl:221-229`` exactly.

    Returns (H*W, 2) array of (ndc_x, ndc_y), row-major over pixels
    (y outer, x inner) like the 2D dispatch grid.
    """
    xs = jnp.arange(width, dtype=jnp.float32) / width
    ys = jnp.arange(height, dtype=jnp.float32) / height
    u, v = jnp.meshgrid(xs, ys, indexing="xy")
    ndc = jnp.stack([u * 2.0 - 1.0, 1.0 - v * 2.0], axis=-1)
    return ndc.reshape(-1, 2)


def unproject_ndc(camera_matrices, ndc):
    """NDC points (R, 2) at clip z=0 -> world-space positions (R, 3).

    Written as broadcast multiply-adds rather than a matmul: JAX's DEFAULT
    matmul precision may be reduced (TF32 on the GPU's tensor cores), and a
    2e-3 relative error in ray directions flips hit/miss classification at
    the box silhouette.  The elementwise form runs at full float32 and
    costs nothing at this size.
    """
    ivp = camera_matrices.inverse_view_proj
    # world = ivp @ (x, y, 0, 1)^T = x*col0 + y*col1 + col3
    world = (
        ndc[:, 0:1] * ivp[:, 0][None, :]
        + ndc[:, 1:2] * ivp[:, 1][None, :]
        + ivp[:, 3][None, :]
    )  # (R, 4)
    return world[:, :3] / world[:, 3:4]


def generate_rays(camera_matrices, height: int, width: int):
    """Per-pixel world-space rays.

    Args:
      camera_matrices: :class:`volym.camera.CameraMatrices` pytree.
    Returns:
      (origin (3,), directions (H*W, 3)) — origin is shared (pinhole).
    """
    ndc = pixel_ndc(height, width)  # (R, 2)
    pos = unproject_ndc(camera_matrices, ndc)
    d = pos - camera_matrices.position[None, :]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return camera_matrices.position, d


def ray_box_intersection(origin, directions):
    """Slab test against [0,1]^3 (``wgsl:162-179``).

    Division by zero direction components yields +/-inf, which the min/max
    slab logic absorbs — same IEEE behaviour as WGSL.

    Returns (entry, exit) each (R,), both clamped to >= 0; a miss is
    ``exit <= entry``.
    """
    t1 = (0.0 - origin[None, :]) / directions
    t2 = (1.0 - origin[None, :]) / directions
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    entry = jnp.max(tmin, axis=-1)
    exit_ = jnp.min(tmax, axis=-1)
    return jnp.maximum(entry, 0.0), jnp.maximum(exit_, 0.0)
