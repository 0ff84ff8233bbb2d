"""Volume sampling primitives (the "texture unit").

Replicates wgpu texture sampling semantics for a (D, H, W) grid addressed by
normalised shader-space positions ``pos = (x, y, z)`` in [0, 1]^3:

- nearest filter, clamp-to-edge: texel ``i = clamp(floor(p*N), 0, N-1)``
  (the reference's volume sampler is wgpu's default = nearest,
  ``src/gpu_resources/volume.rs:96-99``; importance sampler is explicitly
  nearest, ``src/demos/simple/importance.rs:122-131``);
- trilinear filter: texel centres at ``(i+0.5)/N``, corner weights from
  ``frac(p*N - 0.5)``, clamp-to-edge (BASELINE.json config 2).

These are the scalar-gather formulations (XLA ``gather``): the semantic
ground truth every fast path is tested against.

Gradients: both filters are linear in the *grid values* (dL/dvoxel flows
through ``.at[].add`` scatters in the transpose); only trilinear is
differentiable w.r.t. ``pos`` (needed for camera gradients).
"""

from __future__ import annotations

import jax.numpy as jnp


def _grid_dims(grid):
    # grid is (D, H, W) indexed [z, y, x]; pos is (x, y, z).
    d, h, w = grid.shape[-3:]
    return jnp.array([w, h, d], dtype=jnp.float32)


def sample_nearest(grid, pos):
    """Nearest-neighbour sample.

    Args:
      grid: (D, H, W) float array.
      pos: (..., 3) positions (x, y, z) in [0, 1].
    Returns:
      (...,) sampled values.
    """
    n = _grid_dims(grid)
    idx = jnp.clip(jnp.floor(pos * n), 0.0, n - 1.0).astype(jnp.int32)
    return grid[idx[..., 2], idx[..., 1], idx[..., 0]]


def sample_trilinear(grid, pos):
    """Trilinear sample with clamp-to-edge addressing.

    Args:
      grid: (D, H, W) float array.
      pos: (..., 3) positions (x, y, z) in [0, 1].
    Returns:
      (...,) sampled values.
    """
    n = _grid_dims(grid)
    c = pos * n - 0.5
    i0f = jnp.floor(c)
    t = c - i0f  # (..., 3) weights for the +1 corner
    i0 = jnp.clip(i0f, 0.0, n - 1.0).astype(jnp.int32)
    i1 = jnp.clip(i0f + 1.0, 0.0, n - 1.0).astype(jnp.int32)

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

    c000 = grid[z0, y0, x0]
    c001 = grid[z0, y0, x1]
    c010 = grid[z0, y1, x0]
    c011 = grid[z0, y1, x1]
    c100 = grid[z1, y0, x0]
    c101 = grid[z1, y0, x1]
    c110 = grid[z1, y1, x0]
    c111 = grid[z1, y1, x1]

    c00 = c000 * (1 - tx) + c001 * tx
    c01 = c010 * (1 - tx) + c011 * tx
    c10 = c100 * (1 - tx) + c101 * tx
    c11 = c110 * (1 - tx) + c111 * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def make_sampler(interpolation):
    """'nearest' | 'trilinear' -> sampling function."""
    from volym.config import Interpolation

    interp = Interpolation(interpolation)
    return sample_nearest if interp == Interpolation.NEAREST else sample_trilinear


# ----------------------------------------------------------------------
# Scatter transposes, used by the hand-written VJP (render/diff.py).
# ----------------------------------------------------------------------


def scatter_nearest_into(acc, pos, g):
    """Accumulate ``g`` into an existing (D, H, W) gradient grid at the
    nearest-sample voxels (transpose of :func:`sample_nearest` w.r.t. the
    grid).  Accumulating into a carried grid instead of materialising a
    fresh zeros-grid per call is what makes the replay backward O(rays)
    in *bandwidth*, not just memory."""
    d, h, w = acc.shape
    n = jnp.array([w, h, d], dtype=jnp.float32)
    idx = jnp.clip(jnp.floor(pos * n), 0.0, n - 1.0).astype(jnp.int32)
    return acc.at[idx[..., 2], idx[..., 1], idx[..., 0]].add(g)


def scatter_trilinear_into(acc, pos, g):
    """Accumulate ``g`` with trilinear corner weights (transpose of
    :func:`sample_trilinear` w.r.t. the grid)."""
    d, h, w = acc.shape
    n = jnp.array([w, h, d], dtype=jnp.float32)
    c = pos * n - 0.5
    i0f = jnp.floor(c)
    t = c - i0f
    i0 = jnp.clip(i0f, 0.0, n - 1.0).astype(jnp.int32)
    i1 = jnp.clip(i0f + 1.0, 0.0, n - 1.0).astype(jnp.int32)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    for zi, wz in ((z0, 1 - tz), (z1, tz)):
        for yi, wy in ((y0, 1 - ty), (y1, ty)):
            for xi, wx in ((x0, 1 - tx), (x1, tx)):
                acc = acc.at[zi, yi, xi].add(g * wz * wy * wx)
    return acc


def scatter_nearest(grid_shape, pos, g):
    """Fresh-grid variant of :func:`scatter_nearest_into`."""
    return scatter_nearest_into(jnp.zeros(grid_shape, dtype=g.dtype), pos, g)


def scatter_trilinear(grid_shape, pos, g):
    """Fresh-grid variant of :func:`scatter_trilinear_into`."""
    return scatter_trilinear_into(jnp.zeros(grid_shape, dtype=g.dtype), pos, g)


def make_scatter_into(interpolation):
    """'nearest' | 'trilinear' -> accumulate-into-grid scatter function."""
    from volym.config import Interpolation

    interp_ = Interpolation(interpolation)
    return (
        scatter_nearest_into
        if interp_ == Interpolation.NEAREST
        else scatter_trilinear_into
    )
