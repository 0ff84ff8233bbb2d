"""Slab-marching renderer: the high-throughput formulation.

The reference (and our parity renderers) march each ray with uniform
t-steps, which makes every sample an incoherent 3D texture fetch and every
ray's trip count data-dependent.  This module reformulates the *same*
physics slab-by-slab:

- march along the camera's dominant axis, one voxel-center plane per step;
- each sample then lies exactly ON a plane, so trilinear collapses to
  bilinear inside one slice;
- the per-ray step length is constant (``dz / |d_maj|``) and feeds the same
  opacity correction the reference applies per step (``wgsl:314``), so the
  emission-absorption integral is discretised identically, just on a
  per-ray-uniform grid aligned with the volume instead of with t;
- every ray takes the same static number of steps (one per slab), so the
  march is one ``lax.scan`` over slabs whose body gathers from a single
  2D slice.

This file is the plain jnp/lax implementation of the slab semantics
(gather-based, autodiff-friendly), left to XLA on every device: the
production ``slab`` backend, and the ground truth any hand-written kernel
for it must match.

Limitations (by construction): rays whose dominant-axis direction
component opposes the camera forward axis (possible at extreme fov) are
rendered empty.  All reference render modes (coloring, shading, Gaussian
smoothing, importance look-ahead) run slab-natively — see
:func:`lookahead_bits` and :func:`smoothed_densities` for the two
t-parameterised constructs' slab formulations.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from volym.config import Interpolation, RenderParams
from volym.render import rays as rays_mod
from volym.transfer_function import corrected_alpha, lut_sample

#: per major-axis component m: (transpose order for (D,H,W)=[z,y,x] arrays,
#: in-slice row component, in-slice column component) — components are
#: shader-space (x=0, y=1, z=2).
_AXIS_LAYOUT = {
    2: ((0, 1, 2), 1, 0),  # z major: slices [y, x]
    1: ((1, 0, 2), 2, 0),  # y major: slices [z, x]
    0: ((2, 1, 0), 1, 2),  # x major: slices [y, z]
}


def dominant_axis(camera_matrices) -> tuple[int, int]:
    """(major component in (x,y,z), march sign) from the camera forward
    vector.  Host-side / static: cameras are host state, like the
    reference's per-frame uniform upload."""
    view = np.asarray(camera_matrices.view)
    fwd = -view[2, :3]  # view matrix row 2 = -forward
    m = int(np.argmax(np.abs(fwd)))
    return m, (1 if fwd[m] > 0 else -1)


def snap(c, bits: int):
    """Quantize a texel coordinate to ``bits`` fractional fixed-point bits
    (``RenderParams.subtexel_bits`` — hardware-sampler subtexel precision).

    Every operation is exact in f32: ``c * 2^bits`` is a power-of-two
    scaling of a coordinate < 2^16 (so the product < 2^24 stays an exact
    float), ``floor(x + 0.5)`` is deterministic IEEE round-half-up, and the
    final power-of-two scaling is exact — the same inputs give bit-equal
    results on every backend.  Snapped bilinear weights become multiples
    of ``2^-bits``.  ``bits == 0`` is the identity (full-f32
    coordinates)."""
    if not bits:
        return c
    s = float(1 << bits)
    return jnp.floor(c * s + 0.5) * (1.0 / s)


def snap_ste(c, bits: int):
    """:func:`snap` with a straight-through gradient (d snap / d c := 1),
    for the autodiffed jnp paths: the quantizer's a.e.-zero derivative
    would kill camera gradients, so samples sit at the snapped coordinate
    while the gradient chains through the full-precision one.  At
    coordinates that snap exactly ONTO an integer texel (probability
    ~2^-bits per sample) autodiff of :func:`_bilinear_slice` gives the
    right-sided difference v[i+1]-v[i]."""
    if not bits:
        return c
    return c + jax.lax.stop_gradient(snap(c, bits) - c)


def snap_np(c: float, bits: int) -> float:
    """Scalar numpy :func:`snap` for the python-loop test oracles; the
    coordinate must come from the same f32 arithmetic to snap identically
    (see :func:`ray_affine`)."""
    if not bits:
        return c
    s = float(1 << bits)
    return float(np.floor(np.float32(c) * np.float32(s) + np.float32(0.5))) / s


def ray_affine(origin, dirs, n_slabs: int, major: int, sign: int, n_plane: int | None = None):
    """Per-ray affine coefficients of the slab march: ``t(j) = ts*j + tb``
    and sample coordinates ``rows(j) = rs*j + rb``, ``cols(j) = cs*j + cb``
    as functions of the MARCH index j (0 = first slab crossed).

    THE single definition of the march coordinates, shared by the forward
    (:func:`march_slabs`), the replay backward (:func:`_slab_step_f`) and
    the smoothing stencil (:func:`smoothed_densities`) — every site
    evaluates ``slope*j + base`` from the same coefficients, so the
    subtexel snap (:func:`snap`) makes the same decision everywhere and
    the replay reproduces the forward's samples exactly.

    ``n_plane``: in-plane texel resolution of the slices (rows/cols
    scale).  Defaults to ``n_slabs`` (cubic grids); differs on
    slab-axis-resampled grids (:func:`slab_resample` — the step-size
    mapping), where the march has ``n_slabs`` planes but each slice keeps
    the volume's native rows/cols.
    """
    _, row_comp, col_comp = _AXIS_LAYOUT[major]
    o_m, d_m = origin[major], dirs[:, major]
    sz = (1.0 / n_slabs) * sign
    z0 = (0.5 / n_slabs) if sign > 0 else ((n_slabs - 0.5) / n_slabs)
    safe_dm = jnp.where(jnp.abs(d_m) > 1e-12, d_m, 1e-12)
    ts = sz / safe_dm
    tb = (z0 - o_m) / safe_dm
    n = n_slabs if n_plane is None else n_plane
    rs = ts * dirs[:, row_comp] * n
    rb = (origin[row_comp] + tb * dirs[:, row_comp]) * n - 0.5
    cs = ts * dirs[:, col_comp] * n
    cb = (origin[col_comp] + tb * dirs[:, col_comp]) * n - 0.5
    return rs, rb, cs, cb, ts, tb


def slab_resample(vol_perm, planes: int):
    """Linearly resample a permuted grid along the SLAB axis to ``planes``
    sample planes (clamp-to-edge) — the slab path's step-size mapping:
    marching one plane per step over the resampled grid samples the same
    trilinear field the reference's t-march reads at step ``1/planes``
    along the major axis, so ``raymarching_step_size`` maps onto a plane
    count instead of being ignored (reference sweep ``src/main.rs:192``,
    adaptive refinement ``wgsl:243-269``).  Differentiable: gradients
    w.r.t. the resampled grid chain back to the source volume through
    this lerp.  Identity when ``planes`` equals the current count."""
    n = vol_perm.shape[0]
    if planes == n:
        return vol_perm
    s = jnp.clip(
        (jnp.arange(planes, dtype=jnp.float32) + 0.5) * (n / planes) - 0.5,
        0.0,
        n - 1.0,
    )
    lo = jnp.floor(s).astype(jnp.int32)
    hi = jnp.minimum(lo + 1, n - 1)
    w = (s - lo.astype(jnp.float32)).reshape((planes,) + (1,) * (vol_perm.ndim - 1))
    return vol_perm[lo] * (1.0 - w) + vol_perm[hi] * w


def slab_resample_nearest(grid_perm, planes: int):
    """Nearest-neighbour slab-axis resample (for the importance grid,
    which the reference samples with a nearest sampler —
    ``src/demos/simple/importance.rs:122-131``)."""
    n = grid_perm.shape[0]
    if planes == n:
        return grid_perm
    s = (jnp.arange(planes, dtype=jnp.float32) + 0.5) * (n / planes) - 0.5
    idx = jnp.clip(jnp.floor(s + 0.5), 0, n - 1).astype(jnp.int32)
    return grid_perm[idx]


def slab_resample_grad(grad_perm, planes: int):
    """:func:`slab_resample` for a (3, N, rows, cols) gradient field
    (slab axis = axis 1)."""
    if planes == grad_perm.shape[1]:
        return grad_perm
    return slab_resample(
        grad_perm.transpose(1, 0, 2, 3), planes
    ).transpose(1, 0, 2, 3)


def resolve_planes(params, n_slabs: int) -> int:
    """Effective sample-plane count for a render entry: the step-size
    mapping (:func:`step_planes`), with supersampling clamped off under
    Gaussian smoothing (the slab-stencil halo covers at most
    ``SMOOTH_HALO/0.01`` planes; subsampling stays allowed — the Gaussian
    taps are t-parameterised, so they smooth the resampled field
    consistently).  Under smoothing the count is also rounded down to a
    multiple of 8, so every smoothed render of a grid runs on one plane
    ladder."""
    planes = step_planes(params.raymarching_step_size, n_slabs)
    if params.use_gaussian_smoothing:
        from volym.render.golden import GAUSSIAN_KERNEL_SIZE, GAUSSIAN_STEP

        # the stencil's slab-axis reach |u| = K*STEP*planes must fit
        # SMOOTH_HALO: cap the plane count at the halo bound (300 at the
        # reference's K=2, STEP=.005) so over-bound grids (512^3) ride
        # the slab-axis resample instead of a hard error
        halo_max = int(SMOOTH_HALO / (GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP))
        planes = min(planes, n_slabs, halo_max)
        if planes % 8:
            # round DOWN: rounding up could exceed n_slabs (e.g. 100 ->
            # 104) or the halo bound again; subsample-only is the contract
            planes = max(8, planes // 8 * 8)
    return planes


#: step-size factor ladder: plane count multipliers the slab path maps
#: ``raymarching_step_size`` onto (nearest in log space).  A fixed ladder
#: bounds the jit-key set exactly like the window ladder.
STEP_LADDER = (4.0, 2.0, 1.0, 0.5, 0.25)


def step_planes(step_size: float, n_slabs: int) -> int:
    """Sample-plane count for a requested t-step size: the slab march's
    native step along the major axis is ``1/n_slabs``, so the requested
    step maps to the factor ``(1/n_slabs)/step`` bucketed to
    :data:`STEP_LADDER` — finer steps supersample (more planes), coarser
    steps subsample.  The reference sweep {.003,.005,.01,.02} at 256³
    maps to {256, 256, 128, 64} planes."""
    import math

    if step_size <= 0.0:
        return n_slabs
    f = (1.0 / n_slabs) / step_size
    best = min(STEP_LADDER, key=lambda x: abs(math.log(f / x)))
    return max(1, int(round(n_slabs * best)))


def permute_volume(volume, major: int):
    """(D, H, W) grid -> (N_slabs, rows, cols) with the major axis leading."""
    order, _, _ = _AXIS_LAYOUT[major]
    return jnp.transpose(volume, order)


def gradient_volume(volume):
    """Precompute the density gradient field at voxel centres.

    Samples the trilinearly-filtered field at +-GRADIENT_OFFSET (the
    reference's 0.01-normalised central difference, ``wgsl:181-188``):
    0.01 * 256 = 2.56 voxels, i.e. a (0.44, 0.56) blend of the +-2/+-3
    neighbours, clamp-to-edge.  The slab renderers then *interpolate this
    precomputed field* instead of re-fetching six taps per sample — a
    smoother estimator than the reference's (gradient-of-interpolant vs
    interpolant-of-gradient); visually equivalent, and three fetches per
    sample instead of six.

    Returns (3, D, H, W) with channels in shader order (gx, gy, gz).
    """
    import math

    from volym.render.shading import GRADIENT_OFFSET

    d = volume.shape[0]
    off = GRADIENT_OFFSET * d  # texels (python float — shapes are static)
    lo, hi = int(math.floor(off)), int(math.floor(off)) + 1
    frac = off - math.floor(off)

    def shift(axis, by):
        # clamp-to-edge shift along a (D,H,W) axis
        idx = jnp.clip(jnp.arange(d) + by, 0, d - 1)
        return jnp.take(volume, idx, axis=axis)

    grads = []
    for comp in (0, 1, 2):  # shader components x, y, z
        axis = 2 - comp  # array axis for that component
        plus = shift(axis, lo) * (1 - frac) + shift(axis, hi) * frac
        minus = shift(axis, -lo) * (1 - frac) + shift(axis, -hi) * frac
        grads.append((plus - minus) / (2.0 * GRADIENT_OFFSET))
    return jnp.stack(grads)


def _bilinear_slice(sl, rows_c, cols_c):
    """Bilinear sample of one slice at continuous texel coords (already in
    ``p*N - 0.5`` space), clamp-to-edge."""
    nr, nc = sl.shape
    r0f = jnp.floor(rows_c)
    c0f = jnp.floor(cols_c)
    tr = rows_c - r0f
    tc = cols_c - c0f
    r0 = jnp.clip(r0f, 0, nr - 1).astype(jnp.int32)
    r1 = jnp.clip(r0f + 1, 0, nr - 1).astype(jnp.int32)
    c0 = jnp.clip(c0f, 0, nc - 1).astype(jnp.int32)
    c1 = jnp.clip(c0f + 1, 0, nc - 1).astype(jnp.int32)
    v00 = sl[r0, c0]
    v01 = sl[r0, c1]
    v10 = sl[r1, c0]
    v11 = sl[r1, c1]
    return (
        v00 * (1 - tr) * (1 - tc)
        + v01 * (1 - tr) * tc
        + v10 * tr * (1 - tc)
        + v11 * tr * tc
    )


def _nearest_slice(sl, rows_c, cols_c):
    # wgpu nearest: texel floor(p*N) = floor(coords + 0.5) in texel space
    nr, nc = sl.shape
    r = jnp.clip(jnp.floor(rows_c + 0.5), 0, nr - 1).astype(jnp.int32)
    c = jnp.clip(jnp.floor(cols_c + 0.5), 0, nc - 1).astype(jnp.int32)
    return sl[r, c]


#: look-ahead constants shared with the t-step golden (wgsl:133, 291)
IMPORTANT_AHEAD_THRESHOLD = 0.5
IMPORTANCE_OPAQUE = 1.0


def lookahead_bits(
    imp_perm, origin, dirs, entry, exit_, major: int, sign: int,
    cone: bool = False, subtexel: int = 0,
):
    """(n_slabs, R) bool per MARCH step: is an important slab ahead within
    the reference's probe range?

    This is the slab-native formulation of the importance-driven look-ahead
    (``wgsl:141-160`` straight, ``:94-139`` cone): the reference probes K
    discrete points between the sample position and (a quirky estimate of)
    the box exit; here the probe is the K -> infinity continuum limit — any
    important slab crossing strictly ahead of the current step and within
    the probe range triggers the skip.  ``importance_check_ahead_steps``
    (probe density) therefore has no effect on the slab paths; the t-step
    golden (:mod:`volym.render.golden`) keeps the exact discrete-probe
    parity semantics.

    The probe range end reproduces the reference quirk ``max_distance -
    length(pos)`` (t-units minus a *norm from the world origin*).  Probes
    are evaluated at the ray's own slab crossings (straight; masked to
    valid in-box crossings) or along the 8 cone directions re-anchored at
    the camera (cone; masked to in-box crossings, matching the cone
    probe's bounds ``break``).
    """
    n_slabs, n_rows, n_cols = imp_perm.shape
    _, row_comp, col_comp = _AXIS_LAYOUT[major]
    o_m, d_m = origin[major], dirs[:, major]
    dt = (1.0 / n_slabs) / jnp.maximum(jnp.abs(d_m), 1e-12)  # t per march step

    ks = jnp.arange(n_slabs, dtype=jnp.float32)
    if sign < 0:
        ks = ks[::-1]
    ks_int = ks.astype(jnp.int32)
    imp_march = imp_perm[ks_int]  # (M, NR, NC) in march order
    z_m = (ks + 0.5) / n_slabs  # (M,)
    m_ids = jnp.arange(n_slabs, dtype=jnp.float32)

    # probe-range end, in march-step units: the main ray's position at step
    # m is pos_m = origin + t_m * d; range D = exit - |pos_m| (the quirk)
    t_m = (z_m[:, None] - o_m) / jnp.where(jnp.abs(d_m) > 1e-12, d_m, 1e-12)
    c2 = jnp.sum(origin * origin)
    # explicit f32: a float32 matmul may run in TF32 on the GPU
    cd = jnp.matmul(dirs, origin, precision=jax.lax.Precision.HIGHEST)  # (R,)
    norm_pos = jnp.sqrt(jnp.maximum(c2 + 2.0 * t_m * cd[None, :] + t_m * t_m, 0.0))
    d_range = exit_[None, :] - norm_pos  # (M, R) world distance

    def profile_ahead(t_of_m, o_r, d_r, o_c, d_c, rate, inbox_extra=None):
        """Next-important structure for one probe-direction family."""
        rows = (o_r + t_of_m * d_r) * n_rows - 0.5  # (M, R) unclamped
        cols = (o_c + t_of_m * d_c) * n_cols - 0.5
        inbox = (
            (rows >= -0.5) & (rows <= n_rows - 0.5)
            & (cols >= -0.5) & (cols <= n_cols - 0.5)
        )
        if inbox_extra is not None:
            inbox = inbox & inbox_extra
        # probe samples are sampler lookups in the reference
        # (textureSampleLevel, wgsl:150/:129) — fixed-point subtexel
        # coords, like the march's own samples
        rows_s = snap(jnp.clip(rows, 0.0, n_rows - 1.0), subtexel)
        cols_s = snap(jnp.clip(cols, 0.0, n_cols - 1.0), subtexel)
        hit = (
            jax.vmap(_nearest_slice)(imp_march, rows_s, cols_s)
            >= IMPORTANT_AHEAD_THRESHOLD
        ) & inbox
        mvals = jnp.where(hit, m_ids[:, None], jnp.inf)
        ns = jax.lax.associative_scan(jnp.minimum, mvals, reverse=True, axis=0)
        ns_next = jnp.concatenate(
            [ns[1:], jnp.full((1, hit.shape[1]), jnp.inf)], axis=0
        )
        m_end = m_ids[:, None] + d_range * rate[None, :]
        return (ns_next <= m_end) & (rate[None, :] > 0.0)

    if not cone:
        # straight: probes ride the main ray; crossings valid where the
        # main march itself is valid
        valid = (
            ((d_m * sign) > 0.0)[None, :]
            & (t_m >= entry[None, :])
            & (t_m < exit_[None, :])
        )
        rate = 1.0 / dt  # march steps per unit distance along the ray
        return profile_ahead(
            t_m, origin[row_comp], dirs[:, row_comp],
            origin[col_comp], dirs[:, col_comp], rate, inbox_extra=valid,
        )

    from volym.render.golden import cone_directions

    cdirs = cone_directions(dirs)  # (R, S, 3)
    ahead = jnp.zeros((n_slabs, dirs.shape[0]), bool)
    for c in range(cdirs.shape[-2]):
        dc = cdirs[:, c, :]
        dc_m = dc[:, major]
        safe = jnp.where(jnp.abs(dc_m) > 1e-12, dc_m, 1e-12)
        t_c = (z_m[:, None] - o_m) / safe  # (M, R) along the cone dir
        rate_c = dc_m * n_slabs * sign  # march steps per unit cone distance
        ahead = ahead | profile_ahead(
            t_c, origin[row_comp], dc[:, row_comp],
            origin[col_comp], dc[:, col_comp], rate_c,
            inbox_extra=(t_c > 0.0),
        )
    return ahead


#: slab-axis stencil half-width for resampled Gaussian taps: |u| =
#: 0.01 / dt <= 0.01 * 256 = 2.56 slabs, hat support +-1 -> 3
SMOOTH_HALO = 3


def smoothed_densities(vol_perm, origin, dirs, major: int, sign: int, params):
    """(n_slabs, R) Gaussian-smoothed density at every march step.

    The reference smooths along the ray with 5 taps at t-offsets
    i*0.005, i in [-2, 2] (``wgsl:44-75``), masked to in-box positions and
    renormalised.  Slab-native formulation: a tap at t_j + delta lies on
    the ray between slab crossings, and the tap's offset in march-index
    units ``u = delta / dt`` is per-ray CONSTANT — so each tap is a 1D
    hat (trilinear) or box (nearest) combination of the march's own
    plain density rows, and smoothing becomes a 7-row stencil over
    D(j-3..j+3) instead of new 3D samples.  (The between-crossing lerp
    linearises the field along the ray — the same discretisation order
    as the march itself; the t-step golden keeps the exact 3D taps.)
    """
    import math as _math

    from volym.render.golden import (
        GAUSSIAN_KERNEL_SIZE,
        GAUSSIAN_SIGMA,
        GAUSSIAN_STEP,
    )

    n_slabs, n_rows, n_cols = vol_perm.shape
    if GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP * n_slabs > SMOOTH_HALO:
        # the tap offset |u| <= kernel_size*step*N march indices must fit
        # the +-SMOOTH_HALO stencil (2.56 at N=256); beyond it the outer
        # taps would silently get zero weight while still renormalised
        raise NotImplementedError(
            f"Gaussian smoothing stencil (halo {SMOOTH_HALO}) only covers "
            f"volumes up to "
            f"{int(SMOOTH_HALO / (GAUSSIAN_KERNEL_SIZE * GAUSSIAN_STEP))} "
            f"slabs (got {n_slabs}); use the t-step renderers"
        )
    # shared coordinate definition (see ray_affine): slope*j + base per
    # march index j
    rs, rb, cs, cb, dt, _tb = ray_affine(
        origin, dirs, n_slabs, major, sign, n_plane=n_rows
    )
    slope_r, slope_c = rs, cs
    stx = params.subtexel_bits

    ks = jnp.arange(n_slabs, dtype=jnp.float32)
    if sign < 0:
        ks = ks[::-1]
    vol_march = vol_perm[ks.astype(jnp.int32)]
    jf = jnp.arange(n_slabs, dtype=jnp.float32)[:, None]  # march index (M, 1)
    rows_all = rs[None, :] * jf + rb[None, :]
    cols_all = cs[None, :] * jf + cb[None, :]

    bilinear = params.interpolation == Interpolation.TRILINEAR
    sample2d = _bilinear_slice if bilinear else _nearest_slice
    d_all = jax.vmap(sample2d)(
        vol_march,
        snap_ste(jnp.clip(rows_all, 0.0, n_rows - 1.0), stx),
        snap_ste(jnp.clip(cols_all, 0.0, n_cols - 1.0), stx),
    )  # (M, R) plain densities

    m_idx = jnp.arange(n_slabs)
    total = jnp.zeros_like(d_all)
    wsum = jnp.zeros_like(d_all)
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
        delta = i * GAUSSIAN_STEP
        w = _math.exp(-(delta * delta) / (2.0 * GAUSSIAN_SIGMA * GAUSSIAN_SIGMA))
        u = delta / dt  # (R,) march-index offset, per-ray constant
        row_tap = rows_all + u[None, :] * slope_r[None, :]
        col_tap = cols_all + u[None, :] * slope_c[None, :]
        slab_tap = m_idx[:, None].astype(jnp.float32) + u[None, :]
        in_box = (
            (row_tap >= -0.5) & (row_tap <= n_rows - 0.5)
            & (col_tap >= -0.5) & (col_tap <= n_cols - 0.5)
            & (slab_tap >= -0.5) & (slab_tap <= n_slabs - 0.5)
        )
        tap = jnp.zeros_like(d_all)
        for o in range(-SMOOTH_HALO, SMOOTH_HALO + 1):
            if bilinear:
                ker = jnp.maximum(0.0, 1.0 - jnp.abs(u - o))  # (R,)
            else:
                ker = ((u - o >= -0.5) & (u - o < 0.5)).astype(jnp.float32)
            d_sh = d_all[jnp.clip(m_idx + o, 0, n_slabs - 1)]
            tap = tap + ker[None, :] * d_sh
        total = total + w * in_box * tap
        wsum = wsum + w * in_box
    return total / jnp.where(wsum > 0.0, wsum, 1.0)


def march_slabs(
    vol_perm,
    imp_perm,
    lut,
    origin,
    dirs,
    entry,
    exit_,
    major: int,
    sign: int,
    params: RenderParams,
    grad_perm=None,
):
    """Slab-ordered front-to-back march -> (R, 4).

    ``vol_perm``/``imp_perm``: (N, rows, cols) permuted grids.
    ``grad_perm``: (3, N, rows, cols) permuted :func:`gradient_volume`
    (required when ``params.use_shading``).
    """
    n_slabs, n_rows, n_cols = vol_perm.shape
    d_m = dirs[:, major]

    # march direction must match the dominant sign for front-to-back order
    sign_ok = (d_m * sign) > 0.0
    dt = (1.0 / n_slabs) / jnp.maximum(jnp.abs(d_m), 1e-12)  # per-ray step
    alpha_exp = dt * 100.0  # opacity-correction exponent (wgsl:314)

    # shared coordinate definition (see ray_affine)
    rs, rb, cs, cb, ts, tb = ray_affine(
        origin, dirs, n_slabs, major, sign, n_plane=n_rows
    )
    stx = params.subtexel_bits

    ks = jnp.arange(n_slabs, dtype=jnp.float32)
    if sign < 0:
        ks = ks[::-1]
    mis = jnp.arange(n_slabs, dtype=jnp.float32)  # march index

    lookahead = (
        params.use_importance_rendering and not params.use_importance_coloring
    )
    if lookahead:
        ahead_bits = lookahead_bits(
            imp_perm, origin, dirs, entry, exit_, major, sign,
            cone=params.use_cone_importance_check,
            subtexel=params.subtexel_bits,
        )
    else:
        ahead_bits = jnp.zeros((n_slabs, dirs.shape[0]), bool)

    if params.use_gaussian_smoothing:
        smooth_all = smoothed_densities(vol_perm, origin, dirs, major, sign, params)
    else:
        smooth_all = jnp.zeros((n_slabs, 1), jnp.float32)  # unused dummy

    sample2d = (
        _bilinear_slice
        if params.interpolation == Interpolation.TRILINEAR
        else _nearest_slice
    )

    if params.use_shading:
        from volym.render.shading import AMBIENT, DIFFUSE, LIGHT_DIR, SHININESS, SPECULAR

        light = jnp.asarray(LIGHT_DIR, jnp.float32)
        light = light / jnp.linalg.norm(light)
        # eye = normalize(cam_pos - pos) = -ray_dir exactly (pos = cam + t d)
        half = -dirs + light[None, :]
        half = half / jnp.linalg.norm(half, axis=-1, keepdims=True)

    def _shade(rgb, g):
        # Blinn-Phong from the precomputed gradient field (wgsl:190-211)
        from volym.render.shading import AMBIENT, DIFFUSE, SHININESS, SPECULAR, safe_normalize

        n, nonzero = safe_normalize(g)
        diffuse = jnp.maximum(0.0, jnp.sum(n * light[None, :], axis=-1, keepdims=True))
        spec = jnp.maximum(0.0, jnp.sum(half * n, axis=-1, keepdims=True)) ** SHININESS
        shaded = rgb * (AMBIENT + DIFFUSE * diffuse) + SPECULAR * spec
        return jnp.where(nonzero, shaded, rgb)

    def body(carry, x):
        k, mi, ahead_k, smooth_k = x
        acc_c, acc_a = carry
        t = ts * mi + tb  # (R,)
        valid = sign_ok & (t >= entry) & (t < exit_)
        active = valid & (acc_a < params.early_termination_alpha)

        rows_c = snap_ste(jnp.clip(rs * mi + rb, 0.0, n_rows - 1.0), stx)
        cols_c = snap_ste(jnp.clip(cs * mi + cb, 0.0, n_cols - 1.0), stx)
        sl = jax.lax.dynamic_index_in_dim(vol_perm, k.astype(jnp.int32), keepdims=False)
        if params.use_gaussian_smoothing:
            density = smooth_k  # precomputed slab-stencil Gaussian taps
        else:
            density = sample2d(sl, rows_c, cols_c)

        dense = density >= params.density_threshold
        if lookahead:
            # skip-if-important-ahead (wgsl:286-296): a non-opaque sample
            # with important material ahead is skipped
            isl_la = jax.lax.dynamic_index_in_dim(
                imp_perm, k.astype(jnp.int32), keepdims=False
            )
            imp_here = _nearest_slice(isl_la, rows_c, cols_c)
            dense = dense & ~((imp_here < IMPORTANCE_OPAQUE) & ahead_k)

        if params.use_importance_coloring:
            isl = jax.lax.dynamic_index_in_dim(
                imp_perm, k.astype(jnp.int32), keepdims=False
            )
            imp = _nearest_slice(isl, rows_c, cols_c)
            from volym.render.golden import importance_to_color

            color_alpha = importance_to_color(imp)
        else:
            color_alpha = lut_sample(lut, density)

        rgb = color_alpha[..., :3]
        if params.use_shading:
            gsl = jax.lax.dynamic_index_in_dim(grad_perm, k.astype(jnp.int32), axis=1, keepdims=False)
            g = jnp.stack(
                [sample2d(gsl[c], rows_c, cols_c) for c in range(3)], axis=-1
            )
            rgb = _shade(rgb, g)

        m = active & dense
        if not (params.use_opacity or params.use_importance_coloring):
            # first-hit mode (wgsl:319-323): the first contributing sample
            # wins; acc_a = 1 retires the ray via the early-alpha gate
            acc_c = jnp.where(m[:, None], rgb, acc_c)
            acc_a = jnp.where(m, 1.0, acc_a)
            return (acc_c, acc_a), None
        alpha = corrected_alpha(color_alpha[..., 3], alpha_exp)
        w = (1.0 - acc_a) * alpha * m
        acc_c = acc_c + rgb * w[:, None]
        acc_a = acc_a + w
        return (acc_c, acc_a), None

    r = dirs.shape[0]
    init = (jnp.zeros((r, 3), jnp.float32), jnp.zeros((r,), jnp.float32))
    (acc_c, acc_a), _ = jax.lax.scan(body, init, (ks, mis, ahead_bits, smooth_all))
    return jnp.concatenate([acc_c, acc_a[:, None]], axis=-1)


# ----------------------------------------------------------------------
# Differentiable slab march: custom VJP with the same O(rays)-memory
# replay backward as render/diff.py — but the per-step volume cotangent is
# a *slice* update (``dvol[k] += d_slice``) instead of a scatter into the
# whole grid: slab alignment keeps each step's scatter-add inside one
# 2D slice.
# ----------------------------------------------------------------------


def _slab_step_f(params, major, sign, n_slabs, march_idx_f, sl, isl, lut, origin, dirs, gsl=None, density_override=None):
    """Differentiable per-slab quantities: (rgb, alpha), aux density.

    ``march_idx_f``: MARCH index j (0 = first slab crossed), the variable
    the shared affine coordinates (:func:`ray_affine`) are linear in.

    ``density_override``: traced Gaussian-smoothed densities for this step
    (from :func:`smoothed_densities`); the slice sample drops out and the
    override's cotangent is returned by the surrounding ``jax.vjp``.
    """
    n_rows, n_cols = sl.shape
    d_m = dirs[:, major]
    rs, rb, cs, cb, ts, tb = ray_affine(
        origin, dirs, n_slabs, major, sign, n_plane=n_rows
    )
    stx = params.subtexel_bits
    t = ts * march_idx_f + tb
    rows_c = snap_ste(jnp.clip(rs * march_idx_f + rb, 0.0, n_rows - 1.0), stx)
    cols_c = snap_ste(jnp.clip(cs * march_idx_f + cb, 0.0, n_cols - 1.0), stx)

    sample2d = (
        _bilinear_slice
        if params.interpolation == Interpolation.TRILINEAR
        else _nearest_slice
    )
    if density_override is not None:
        density = density_override
    else:
        density = sample2d(sl, rows_c, cols_c)
    if params.use_importance_coloring:
        from volym.render.golden import importance_to_color

        imp = _nearest_slice(isl, rows_c, cols_c)
        color_alpha = importance_to_color(imp)
    else:
        color_alpha = lut_sample(lut, density)
    rgb = color_alpha[..., :3]
    if params.use_shading:
        # same Blinn-Phong-from-gradient-field as march_slabs._shade;
        # jax.vjp in the replay machine-derives its backward (incl. the
        # sampling-position chain)
        from volym.render.shading import (
            AMBIENT, DIFFUSE, LIGHT_DIR, SHININESS, SPECULAR, safe_normalize,
        )

        light = jnp.asarray(LIGHT_DIR, jnp.float32)
        light = light / jnp.linalg.norm(light)
        half = -dirs + light[None, :]
        half = half / jnp.linalg.norm(half, axis=-1, keepdims=True)
        g = jnp.stack(
            [sample2d(gsl[c], rows_c, cols_c) for c in range(3)], axis=-1
        )
        n, nonzero = safe_normalize(g)
        diffuse = jnp.maximum(
            0.0, jnp.sum(n * light[None, :], axis=-1, keepdims=True)
        )
        spec = (
            jnp.maximum(0.0, jnp.sum(half * n, axis=-1, keepdims=True))
            ** SHININESS
        )
        shaded = rgb * (AMBIENT + DIFFUSE * diffuse) + SPECULAR * spec
        rgb = jnp.where(nonzero, shaded, rgb)
    aexp = (1.0 / n_slabs) / jnp.maximum(jnp.abs(d_m), 1e-12) * 100.0
    alpha = corrected_alpha(color_alpha[..., 3], aexp)
    return (rgb, alpha), (density, t, rows_c, cols_c)


def _slab_mask(params, density, t, entry, exit_, sign_ok, acc_a):
    return (
        sign_ok
        & (t >= entry)
        & (t < exit_)
        & (density >= params.density_threshold)
        & (acc_a < params.early_termination_alpha)
    )


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def march_slabs_diff(params, major, sign, vol_perm, imp_perm, lut, origin, dirs, entry, exit_, grad_perm=None):
    """Differentiable slab march -> (R, 4); grads w.r.t. the permuted
    volume, importance, LUT, the camera (origin/dirs/entry), and — when
    shading — the precomputed gradient field ``grad_perm``.

    All render modes differentiate: Gaussian smoothing chains through
    :func:`smoothed_densities` (the replay accumulates the per-step
    smoothed-density cotangent and pulls it back in one VJP), and the
    importance look-ahead gate — built purely from comparisons — is a
    zero-gradient mask a.e., exactly as autodiff of :func:`march_slabs`
    treats it (straight-through on the skipped samples)."""
    return march_slabs(
        vol_perm, imp_perm, lut, origin, dirs, entry, exit_, major, sign,
        params, grad_perm,
    )


def _msd_fwd(params, major, sign, vol_perm, imp_perm, lut, origin, dirs, entry, exit_, grad_perm=None):
    img = march_slabs(
        vol_perm, imp_perm, lut, origin, dirs, entry, exit_, major, sign,
        params, grad_perm,
    )
    return img, (vol_perm, imp_perm, lut, origin, dirs, entry, exit_, grad_perm, img)


def _msd_bwd(params, major, sign, res, g):
    vol_perm, imp_perm, lut, origin, dirs, entry, exit_, grad_perm, img = res
    g_c, g_a = g[:, :3], g[:, 3]
    fin_c, fin_a = img[:, :3], img[:, 3]
    n_slabs = vol_perm.shape[0]
    d_m = dirs[:, major]
    sign_ok = (d_m * sign) > 0.0

    ks = jnp.arange(n_slabs, dtype=jnp.float32)
    if sign < 0:
        ks = ks[::-1]

    lookahead = (
        params.use_importance_rendering and not params.use_importance_coloring
    )
    if lookahead:
        ahead_all = lookahead_bits(
            imp_perm, origin, dirs, entry, exit_, major, sign,
            cone=params.use_cone_importance_check,
            subtexel=params.subtexel_bits,
        )
    else:
        ahead_all = jnp.zeros((n_slabs, 1), bool)

    smoothing = params.use_gaussian_smoothing
    if smoothing:
        smooth_all, smooth_vjp = jax.vjp(
            lambda vp, o, d: smoothed_densities(vp, o, d, major, sign, params),
            vol_perm, origin, dirs,
        )
    else:
        smooth_all = jnp.zeros((n_slabs, 1), jnp.float32)

    r = dirs.shape[0]

    def body(carry, x):
        k, mi, ahead_k, smooth_k = x
        acc_c, acc_a, dvol, dimp, dlut, dorigin, ddirs, dgrad, dsmooth = carry
        ki = k.astype(jnp.int32)
        sl = jax.lax.dynamic_index_in_dim(vol_perm, ki, keepdims=False)
        isl = jax.lax.dynamic_index_in_dim(imp_perm, ki, keepdims=False)
        ov = smooth_k if smoothing else None

        if params.use_shading:
            gsl = jax.lax.dynamic_index_in_dim(
                grad_perm, ki, axis=1, keepdims=False
            )
            if smoothing:

                def f(sl_, isl_, lut_, origin_, dirs_, gsl_, ov_):
                    return _slab_step_f(
                        params, major, sign, n_slabs, mi, sl_, isl_, lut_,
                        origin_, dirs_, gsl_, ov_,
                    )

                ((rgb, alpha), f_vjp, aux) = jax.vjp(
                    f, sl, isl, lut, origin, dirs, gsl, ov, has_aux=True
                )
            else:

                def f(sl_, isl_, lut_, origin_, dirs_, gsl_):
                    return _slab_step_f(
                        params, major, sign, n_slabs, mi, sl_, isl_, lut_,
                        origin_, dirs_, gsl_,
                    )

                ((rgb, alpha), f_vjp, aux) = jax.vjp(
                    f, sl, isl, lut, origin, dirs, gsl, has_aux=True
                )
        elif smoothing:

            def f(sl_, isl_, lut_, origin_, dirs_, ov_):
                return _slab_step_f(
                    params, major, sign, n_slabs, mi, sl_, isl_, lut_,
                    origin_, dirs_, None, ov_,
                )

            ((rgb, alpha), f_vjp, aux) = jax.vjp(
                f, sl, isl, lut, origin, dirs, ov, has_aux=True
            )
        else:

            def f(sl_, isl_, lut_, origin_, dirs_):
                return _slab_step_f(
                    params, major, sign, n_slabs, mi, sl_, isl_, lut_,
                    origin_, dirs_,
                )

            ((rgb, alpha), f_vjp, aux) = jax.vjp(
                f, sl, isl, lut, origin, dirs, has_aux=True
            )
        density, t, rows_c, cols_c = aux
        m = _slab_mask(params, density, t, entry, exit_, sign_ok, acc_a)
        if lookahead:
            # skip-if-important-ahead (march_slabs): pure comparisons,
            # zero gradient — replicate the forward mask exactly
            imp_here = _nearest_slice(isl, rows_c, cols_c)
            m = m & ~((imp_here < IMPORTANCE_OPAQUE) & ahead_k)
        beta = alpha * m
        t_k = 1.0 - acc_a
        w = t_k * beta

        new_acc_c = acc_c + rgb * w[:, None]
        new_acc_a = acc_a + w
        suf_c = fin_c - new_acc_c
        suf_a = fin_a - new_acc_a

        d_rgb = g_c * w[:, None]
        inv = 1.0 / jnp.maximum(1.0 - beta, 1e-7)
        d_beta = (
            t_k * (jnp.sum(g_c * rgb, axis=-1) + g_a)
            - (jnp.sum(g_c * suf_c, axis=-1) + g_a * suf_a) * inv
        )
        d_alpha = jnp.where(m, d_beta, 0.0)

        outs = list(f_vjp((d_rgb, d_alpha)))
        if smoothing:
            dsmooth = dsmooth.at[ki].add(outs.pop())
        if params.use_shading:
            dgrad = dgrad.at[:, ki].add(outs.pop())
        d_sl, d_isl, d_lut_g, d_origin_g, d_dirs_g = outs
        dvol = dvol.at[ki].add(d_sl)
        dimp = dimp.at[ki].add(d_isl)
        dlut = dlut + d_lut_g
        dorigin = dorigin + d_origin_g
        ddirs = ddirs + d_dirs_g
        return (
            new_acc_c, new_acc_a, dvol, dimp, dlut, dorigin, ddirs, dgrad,
            dsmooth,
        ), None

    init = (
        jnp.zeros((r, 3), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros_like(vol_perm),
        jnp.zeros_like(imp_perm),
        jnp.zeros_like(lut),
        jnp.zeros_like(origin),
        jnp.zeros_like(dirs),
        jnp.zeros_like(grad_perm) if params.use_shading else jnp.zeros((0,)),
        jnp.zeros((n_slabs, r), jnp.float32) if smoothing else jnp.zeros((0,)),
    )
    ahead_xs = ahead_all if lookahead else jnp.zeros((n_slabs, 1), bool)
    smooth_xs = smooth_all if smoothing else jnp.zeros((n_slabs, 1), jnp.float32)
    mis = jnp.arange(n_slabs, dtype=jnp.float32)
    (
        (_, _, dvol, dimp, dlut, dorigin, ddirs, dgrad, dsmooth), _
    ) = jax.lax.scan(body, init, (ks, mis, ahead_xs, smooth_xs))
    if smoothing:
        # dsmooth is indexed by PHYSICAL slab k (ki scatter); smoothed_
        # densities returns march order — map back before the pullback
        ks_int = ks.astype(jnp.int32)
        dv_s, do_s, dd_s = smooth_vjp(dsmooth[ks_int])
        dvol = dvol + dv_s
        dorigin = dorigin + do_s
        ddirs = ddirs + dd_s
    d_grad_perm = dgrad if params.use_shading else None
    return (
        dvol, dimp, dlut, dorigin, ddirs,
        jnp.zeros_like(entry), jnp.zeros_like(exit_), d_grad_perm,
    )


march_slabs_diff.defvjp(_msd_fwd, _msd_bwd)


@partial(
    jax.jit,
    static_argnames=("params", "height", "width", "major", "sign", "planes"),
)
def _render_diff_jit(scene, camera_matrices, params, height, width, major, sign, planes=None):
    vol_perm = permute_volume(scene.volume, major)
    if planes is None:
        planes = vol_perm.shape[0]
    vol_perm = slab_resample(vol_perm, planes)
    imp_perm = slab_resample_nearest(permute_volume(scene.importance, major), planes)
    # gradient_volume is jnp, so d(grad_perm) chains back to the volume
    grad_perm = (
        slab_resample_grad(permute_gradient(gradient_volume(scene.volume), major), planes)
        if params.use_shading
        else None
    )
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march_slabs_diff(
        params, major, sign, vol_perm, imp_perm, scene.tf_lut, origin, dirs,
        entry, jax.lax.stop_gradient(exit_), grad_perm,
    )
    miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    img = jnp.where(miss[:, None], miss_color[None, :], img)
    return img.reshape(height, width, 4)


def render_diff(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Differentiable slab render (custom replay VJP): every render mode —
    base, coloring, shading, Gaussian smoothing (chained through
    :func:`smoothed_densities`), and importance look-ahead (zero-gradient
    gate, as autodiff of the forward treats it)."""
    if not params.use_opacity:
        raise NotImplementedError(
            "slab mode always alpha-composites; the first-hit (use_opacity="
            "False) mode (wgsl:319-323) needs the t-step renderers"
        )
    major, sign = dominant_axis(camera_matrices)
    return _render_diff_jit(
        scene, camera_matrices, params.slab_static(), height, width, major,
        sign, planes=resolve_planes(params, scene.volume.shape[0]),
    )


def permute_gradient(grad, major: int):
    """(3, D, H, W) gradient field -> (3, N, rows, cols)."""
    return jnp.stack([permute_volume(grad[c], major) for c in range(3)])


@partial(
    jax.jit,
    static_argnames=("params", "height", "width", "major", "sign", "planes"),
)
def _render_jit(scene, camera_matrices, params, height, width, major, sign, planes=None):
    vol_perm = permute_volume(scene.volume, major)
    if planes is None:
        planes = vol_perm.shape[0]
    vol_perm = slab_resample(vol_perm, planes)
    imp_perm = slab_resample_nearest(permute_volume(scene.importance, major), planes)
    grad_perm = (
        slab_resample_grad(permute_gradient(gradient_volume(scene.volume), major), planes)
        if params.use_shading
        else None
    )
    origin, dirs = rays_mod.generate_rays(camera_matrices, height, width)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    miss = exit_ <= entry
    img = march_slabs(
        vol_perm, imp_perm, scene.tf_lut, origin, dirs, entry, exit_, major, sign,
        params, grad_perm,
    )
    miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
    img = jnp.where(miss[:, None], miss_color[None, :], img)
    return img.reshape(height, width, 4)


def render(scene, camera_matrices, params: RenderParams, height: int, width: int):
    """Slab-marching render -> (H, W, 4) (jnp golden for the slab mode).

    Shading uses the precomputed :func:`gradient_volume` estimator.
    Importance-driven look-ahead (straight and cone) uses the slab-native
    continuum formulation (:func:`lookahead_bits`); Gaussian smoothing
    uses the slab-stencil resampling (:func:`smoothed_densities`).
    ``use_opacity=False`` renders first-hit-then-break (wgsl:319-323) at
    the slab discretisation.
    """
    major, sign = dominant_axis(camera_matrices)
    return _render_jit(
        scene, camera_matrices, params.slab_static(), height, width, major,
        sign, planes=resolve_planes(params, scene.volume.shape[0]),
    )
