"""Slab-marching renderer tests: scalar oracle and replay-VJP gradients
(SURVEY.md section 4 items 1-3)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import slab_oracle
from volym import Camera, RenderParams, Scene
from volym.render import slab

SIDE = 16
RES = 8

PARAMS = RenderParams(
    use_gaussian_smoothing=False,
    use_shading=False,
    interpolation="trilinear",
    raymarching_step_size=0.05,
    adaptive_stepping=False,
)


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("sphere", side=SIDE)


@pytest.fixture(scope="module")
def cam():
    return Camera(aspect=1.0, distance=1.2).orbit(30.0, 20.0, 0.0)


def _scalar_slab_render(vol, lut, cam, params, height, width, imp=None):
    """The NumPy slab oracle (tests/slab_oracle.py); ``imp`` defaults to
    an all-zero importance grid."""
    if imp is None:
        imp = np.zeros_like(vol)
    return slab_oracle.render(vol, imp, lut, cam, params, height, width)


def test_slab_golden_matches_scalar(scene, cam):
    vol = np.asarray(scene.volume)
    lut = np.asarray(scene.tf_lut)
    expect = _scalar_slab_render(vol, lut, cam, PARAMS, RES, RES)
    got = np.asarray(slab.render(scene, cam.matrices(), PARAMS, RES, RES))
    assert (expect[..., 3] > 0.05).mean() > 0.1, "oracle camera misses content"
    err = np.abs(got - expect).max(-1)
    assert (err > 2e-3).mean() <= 0.05, f"max err {err.max()}"


@pytest.mark.parametrize("hv", [(0.0, 0.0), (120.0, -30.0), (220.0, 50.0)])
def test_slab_all_major_axes(scene, hv):
    cam = Camera(aspect=1.0, distance=1.2).orbit(*hv, 0.0)
    img = np.asarray(slab.render(scene, cam.matrices(), PARAMS, RES, RES))
    assert np.isfinite(img).all()
    assert img[..., 3].max() > 0.1  # something rendered


def test_slab_shading_mode(scene, cam):
    """Shaded slab render: precomputed-gradient Blinn-Phong estimator."""
    params = PARAMS.replace(use_shading=True)
    img = np.asarray(slab.render(scene, cam.matrices(), params, RES, RES))
    base = np.asarray(slab.render(scene, cam.matrices(), PARAMS, RES, RES))
    assert np.isfinite(img).all()
    # alpha identical (shading touches colour only); colours differ
    np.testing.assert_allclose(img[..., 3], base[..., 3], atol=1e-6)
    assert np.abs(img[..., :3] - base[..., :3]).max() > 1e-3


def _lookahead_scene():
    """16^3: uniform haze plus an important dense band deep along +z."""
    side = 16
    vol = np.full((side, side, side), 0.45, np.float32)
    imp = np.zeros((side, side, side), np.float32)
    vol[10:13, 4:12, 4:12] = 0.9
    imp[10:13, 4:12, 4:12] = 1.0  # importance 255/255 -> opaque-important
    from volym.scene import Scene as S

    return S(
        volume=jnp.asarray(vol),
        importance=jnp.asarray(imp),
        tf_lut=Scene.synthetic("sphere", side=8).tf_lut,
    )


def test_slab_lookahead_matches_scalar_oracle():
    """Slab-native (continuum) straight look-ahead vs the python oracle."""
    sc = _lookahead_scene()
    cam = Camera(aspect=1.0, distance=1.3).orbit(10.0, 5.0, 0.0)
    p = PARAMS.replace(use_importance_rendering=True)
    expect = _scalar_slab_render(
        np.asarray(sc.volume), np.asarray(sc.tf_lut), cam, p, RES, RES,
        imp=np.asarray(sc.importance),
    )
    got = np.asarray(slab.render(sc, cam.matrices(), p, RES, RES))
    err = np.abs(got - expect).max(-1)
    assert (err > 2e-3).mean() <= 0.05, f"max err {err.max()}"
    # and the skip actually changed the image vs base rendering
    base = np.asarray(slab.render(sc, cam.matrices(), PARAMS, RES, RES))
    assert np.abs(got - base).max() > 0.05


def test_slab_lookahead_zero_importance_is_base():
    scene = Scene.synthetic("sphere", side=SIDE)  # importance all zero
    cam = Camera(aspect=1.0, distance=1.2).orbit(30.0, 20.0, 0.0)
    for cone in (False, True):
        p = PARAMS.replace(
            use_importance_rendering=True, use_cone_importance_check=cone
        )
        a = np.asarray(slab.render(scene, cam.matrices(), p, RES, RES))
        b = np.asarray(slab.render(scene, cam.matrices(), PARAMS, RES, RES))
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_slab_lookahead_cone_runs():
    sc = _lookahead_scene()
    cam = Camera(aspect=1.0, distance=1.3).orbit(10.0, 5.0, 0.0)
    p = PARAMS.replace(
        use_importance_rendering=True, use_cone_importance_check=True
    )
    img = np.asarray(slab.render(sc, cam.matrices(), p, RES, RES))
    assert np.isfinite(img).all()
    base = np.asarray(slab.render(sc, cam.matrices(), PARAMS, RES, RES))
    assert np.abs(img - base).max() > 0.05  # cone skip engaged


def test_slab_smoothing_constant_volume_exact(cam):
    """On a constant-density volume, Gaussian smoothing is the identity
    (masked-tap renormalisation included)."""
    side = 16
    vol = np.full((side, side, side), 0.5, np.float32)
    from volym.scene import Scene as S

    sc = S(
        volume=jnp.asarray(vol),
        importance=jnp.zeros((side,) * 3, jnp.float32),
        tf_lut=Scene.synthetic("sphere", side=8).tf_lut,
    )
    m = cam.matrices()
    a = np.asarray(slab.render(sc, m, PARAMS, RES, RES))
    b = np.asarray(
        slab.render(sc, m, PARAMS.replace(use_gaussian_smoothing=True), RES, RES)
    )
    np.testing.assert_allclose(b, a, atol=1e-5)


def test_slab_smoothing_blurs_noise(scene, cam):
    """Smoothing changes the image on a structured volume and stays finite."""
    m = cam.matrices()
    p = PARAMS.replace(use_gaussian_smoothing=True)
    a = np.asarray(slab.render(scene, m, PARAMS, RES, RES))
    b = np.asarray(slab.render(scene, m, p, RES, RES))
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() > 1e-4


def test_smoothed_densities_matches_loop_oracle(scene, cam):
    """Vectorised smoothed_densities vs a literal numpy-loop transcription
    of the slab-stencil spec, for a few (step, ray) entries."""
    import math

    from volym.render import rays as rays_mod
    from volym.render.golden import (
        GAUSSIAN_KERNEL_SIZE,
        GAUSSIAN_SIGMA,
        GAUSSIAN_STEP,
    )

    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    vol_perm = slab.permute_volume(scene.volume, major)
    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    got = np.asarray(
        slab.smoothed_densities(vol_perm, origin, dirs, major, sign, PARAMS)
    )
    n = vol_perm.shape[0]
    _, row_comp, col_comp = slab._AXIS_LAYOUT[major]
    vp = np.asarray(vol_perm)
    o = np.asarray(origin)
    dnp = np.asarray(dirs)
    ks = list(range(n) if sign > 0 else range(n - 1, -1, -1))

    def bilin(sl2d, rc, cc):
        # clamp then snap, matching the implementation's plain-row sampling
        rc = slab.snap_np(min(max(rc, 0.0), n - 1.0), PARAMS.subtexel_bits)
        cc = slab.snap_np(min(max(cc, 0.0), n - 1.0), PARAMS.subtexel_bits)
        r0, c0 = int(np.floor(rc)), int(np.floor(cc))
        r1, c1 = min(r0 + 1, n - 1), min(c0 + 1, n - 1)
        tr, tc = rc - r0, cc - c0
        return (
            sl2d[r0, c0] * (1 - tr) * (1 - tc)
            + sl2d[r0, c1] * (1 - tr) * tc
            + sl2d[r1, c0] * tr * (1 - tc)
            + sl2d[r1, c1] * tr * tc
        )

    rng = np.random.default_rng(3)
    for _ in range(6):
        r = int(rng.integers(0, RES * RES))
        mi = int(rng.integers(0, n))
        d = dnp[r]
        dm = d[major] if abs(d[major]) > 1e-12 else 1e-12
        dt = (1.0 / n) * sign / dm

        def coords(step_idx):
            k = ks[step_idx]
            z = (k + 0.5) / n
            t = (z - o[major]) / dm
            return (
                (o[row_comp] + t * d[row_comp]) * n - 0.5,
                (o[col_comp] + t * d[col_comp]) * n - 0.5,
            )

        def d_at(step_idx):
            step_idx = min(max(step_idx, 0), n - 1)
            rc, cc = coords(step_idx)
            return bilin(vp[ks[step_idx]], rc, cc)

        total = wsum = 0.0
        for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
            delta = i * GAUSSIAN_STEP
            w = math.exp(-(delta**2) / (2 * GAUSSIAN_SIGMA**2))
            u = delta / dt
            rc, cc = coords(mi)
            rt = rc + u * dt * d[row_comp] * n
            ct = cc + u * dt * d[col_comp] * n
            st = mi + u
            if not (
                -0.5 <= rt <= n - 0.5
                and -0.5 <= ct <= n - 0.5
                and -0.5 <= st <= n - 0.5
            ):
                continue
            tap = 0.0
            for off in range(-slab.SMOOTH_HALO, slab.SMOOTH_HALO + 1):
                ker = max(0.0, 1.0 - abs(u - off))
                if ker:
                    tap += ker * d_at(mi + off)
            total += w * tap
            wsum += w
        expect = total / wsum if wsum > 0 else 0.0
        np.testing.assert_allclose(got[mi, r], expect, atol=2e-5)


def test_gradient_volume_matches_reference_estimator(scene):
    """gradient_volume at voxel centres == central differences of the
    trilinear field at +-GRADIENT_OFFSET (the wgsl:181-188 stencil)."""
    from volym.ops import interp
    from volym.render.shading import GRADIENT_OFFSET

    g = np.asarray(slab.gradient_volume(scene.volume))
    n = scene.volume.shape[0]
    rng = np.random.default_rng(0)
    for _ in range(5):
        v = rng.integers(2, n - 3, size=3)  # interior voxel (z, y, x)
        centre = (np.array([v[2], v[1], v[0]], np.float32) + 0.5) / n  # (x,y,z)
        for comp in range(3):
            off = np.zeros(3, np.float32)
            off[comp] = GRADIENT_OFFSET
            hi = float(interp.sample_trilinear(scene.volume, jnp.asarray(centre + off)))
            lo = float(interp.sample_trilinear(scene.volume, jnp.asarray(centre - off)))
            expect = (hi - lo) / (2 * GRADIENT_OFFSET)
            np.testing.assert_allclose(g[comp, v[0], v[1], v[2]], expect, atol=1e-4)


def test_slab_diff_forward_identical(scene, cam):
    a = np.asarray(slab.render(scene, cam.matrices(), PARAMS, RES, RES))
    b = np.asarray(slab.render_diff(scene, cam.matrices(), PARAMS, RES, RES))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_slab_replay_vjp_matches_autodiff(scene, cam):
    """The replay backward must equal plain autodiff through march_slabs."""
    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    from volym.render import rays as rays_mod

    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    wvec = jnp.cos(jnp.arange(RES * RES * 4, dtype=jnp.float32).reshape(-1, 4) * 0.1)

    def loss_auto(vol, imp, lut):
        vp = slab.permute_volume(vol, major)
        ip = slab.permute_volume(imp, major)
        img = slab.march_slabs(vp, ip, lut, origin, dirs, entry, exit_, major, sign, PARAMS)
        return jnp.sum(img * wvec)

    def loss_custom(vol, imp, lut):
        vp = slab.permute_volume(vol, major)
        ip = slab.permute_volume(imp, major)
        img = slab.march_slabs_diff(PARAMS, major, sign, vp, ip, lut, origin, dirs, entry, exit_)
        return jnp.sum(img * wvec)

    args = (scene.volume, scene.importance, scene.tf_lut)
    g_auto = jax.grad(loss_auto, argnums=(0, 1, 2))(*args)
    g_custom = jax.grad(loss_custom, argnums=(0, 1, 2))(*args)
    for name, a, b in zip(("volume", "importance", "tf_lut"), g_auto, g_custom):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=3e-3 * scale, rtol=2e-2, err_msg=name)
    assert np.abs(np.asarray(g_auto[0])).max() > 0


def test_slab_camera_grads(scene, cam):
    """Slab replay VJP propagates to ray origin/directions."""
    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    from volym.render import rays as rays_mod

    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    vp = slab.permute_volume(scene.volume, major)
    ip = slab.permute_volume(scene.importance, major)

    def loss(fn, o, d):
        img = fn(vp, ip, scene.tf_lut, o, d, entry, exit_)
        return jnp.sum(img[:, :3])

    auto = lambda v, i, l, o, d, e, x: slab.march_slabs(v, i, l, o, d, e, x, major, sign, PARAMS)
    cust = lambda v, i, l, o, d, e, x: slab.march_slabs_diff(PARAMS, major, sign, v, i, l, o, d, e, x)
    g_auto = jax.grad(lambda o, d: loss(auto, o, d), argnums=(0, 1))(origin, dirs)
    g_cust = jax.grad(lambda o, d: loss(cust, o, d), argnums=(0, 1))(origin, dirs)
    for a, b in zip(g_auto, g_cust):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=5e-3 * scale, rtol=5e-2)
    assert np.abs(np.asarray(g_auto[1])).max() > 0


def test_slab_shading_vjp_matches_autodiff(scene, cam):
    """Shaded replay VJP == plain autodiff through march_slabs (incl. the
    gradient-field cotangent and the chain back to the volume)."""
    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    from volym.render import rays as rays_mod

    params = PARAMS.replace(use_shading=True)
    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    wvec = jnp.cos(jnp.arange(RES * RES * 4, dtype=jnp.float32).reshape(-1, 4) * 0.1)

    def loss_auto(vol, lut):
        vp = slab.permute_volume(vol, major)
        ip = slab.permute_volume(scene.importance, major)
        gp = slab.permute_gradient(slab.gradient_volume(vol), major)
        img = slab.march_slabs(
            vp, ip, lut, origin, dirs, entry, exit_, major, sign, params, gp
        )
        return jnp.sum(img * wvec)

    def loss_custom(vol, lut):
        vp = slab.permute_volume(vol, major)
        ip = slab.permute_volume(scene.importance, major)
        gp = slab.permute_gradient(slab.gradient_volume(vol), major)
        img = slab.march_slabs_diff(
            params, major, sign, vp, ip, lut, origin, dirs, entry, exit_, gp
        )
        return jnp.sum(img * wvec)

    args = (scene.volume, scene.tf_lut)
    g_auto = jax.grad(loss_auto, argnums=(0, 1))(*args)
    g_custom = jax.grad(loss_custom, argnums=(0, 1))(*args)
    for name, a, b in zip(("volume", "tf_lut"), g_auto, g_custom):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=3e-3 * scale, rtol=2e-2, err_msg=name)
    assert np.abs(np.asarray(g_auto[0])).max() > 0


def test_slab_render_diff_shading_runs(scene, cam):
    """render_diff with shading: forward matches render, grads finite."""
    m = cam.matrices()
    params = PARAMS.replace(use_shading=True)
    a = np.asarray(slab.render(scene, m, params, RES, RES))
    b = np.asarray(slab.render_diff(scene, m, params, RES, RES))
    np.testing.assert_allclose(b, a, atol=1e-6)

    def loss(vol):
        from volym.scene import Scene as S

        img = slab.render_diff(
            S(vol, scene.importance, scene.tf_lut), m, params, RES, RES
        )
        return jnp.sum(img)

    g = jax.grad(loss)(scene.volume)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).max() > 0


@pytest.mark.parametrize("interp", ["trilinear", "nearest"])
def test_slab_smoothing_vjp_matches_autodiff(scene, cam, interp):
    """Gaussian-smoothed replay VJP == plain autodiff through march_slabs
    (density chained through smoothed_densities)."""
    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    from volym.render import rays as rays_mod

    params = PARAMS.replace(use_gaussian_smoothing=True, interpolation=interp)
    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    wvec = jnp.cos(jnp.arange(RES * RES * 4, dtype=jnp.float32).reshape(-1, 4) * 0.1)

    def loss(fn, vol, lut, o, d):
        vp = slab.permute_volume(vol, major)
        ip = slab.permute_volume(scene.importance, major)
        img = fn(vp, ip, lut, o, d)
        return jnp.sum(img * wvec)

    auto = lambda vp, ip, l, o, d: slab.march_slabs(
        vp, ip, l, o, d, entry, exit_, major, sign, params
    )
    cust = lambda vp, ip, l, o, d: slab.march_slabs_diff(
        params, major, sign, vp, ip, l, o, d, entry, exit_
    )
    args = (scene.volume, scene.tf_lut, origin, dirs)
    g_auto = jax.grad(partial(loss, auto), argnums=(0, 1, 2, 3))(*args)
    g_cust = jax.grad(partial(loss, cust), argnums=(0, 1, 2, 3))(*args)
    for name, a, b in zip(("volume", "tf_lut", "origin", "dirs"), g_auto, g_cust):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=3e-3 * scale, rtol=2e-2, err_msg=name)
    assert np.abs(np.asarray(g_auto[0])).max() > 0


@pytest.mark.parametrize("cone", [False, True])
def test_slab_lookahead_vjp_matches_autodiff(cone):
    """Look-ahead replay VJP == plain autodiff through march_slabs (the
    gate is comparisons-only, so grads flow through unskipped samples)."""
    from volym import Camera
    from volym.render import rays as rays_mod
    from volym.scene import Scene as S

    side = 16
    vol = np.full((side, side, side), 0.45, np.float32)
    imp = np.zeros((side, side, side), np.float32)
    vol[10:13, 4:12, 4:12] = 0.9
    imp[10:13, 4:12, 4:12] = 1.0
    sc = S(
        volume=jnp.asarray(vol), importance=jnp.asarray(imp),
        tf_lut=Scene.synthetic("sphere", side=8).tf_lut,
    )
    m = Camera(aspect=1.0, distance=1.3).orbit(10.0, 5.0, 0.0).matrices()
    major, sign = slab.dominant_axis(m)
    params = PARAMS.replace(
        use_importance_rendering=True, use_cone_importance_check=cone
    )
    origin, dirs = rays_mod.generate_rays(m, RES, RES)
    entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
    wvec = jnp.cos(jnp.arange(RES * RES * 4, dtype=jnp.float32).reshape(-1, 4) * 0.1)

    vp = slab.permute_volume(sc.volume, major)
    ip = slab.permute_volume(sc.importance, major)
    base = slab.march_slabs(
        vp, ip, sc.tf_lut, origin, dirs, entry, exit_, major, sign,
        PARAMS,
    )
    la = slab.march_slabs(
        vp, ip, sc.tf_lut, origin, dirs, entry, exit_, major, sign, params
    )
    assert np.abs(np.asarray(la) - np.asarray(base)).max() > 0.05, "not engaged"

    def loss(fn, vol, lut):
        vpp = slab.permute_volume(vol, major)
        img = fn(vpp, lut)
        return jnp.sum(img * wvec)

    auto = lambda vpp, l: slab.march_slabs(
        vpp, ip, l, origin, dirs, entry, exit_, major, sign, params
    )
    cust = lambda vpp, l: slab.march_slabs_diff(
        params, major, sign, vpp, ip, l, origin, dirs, entry, exit_
    )
    args = (sc.volume, sc.tf_lut)
    g_auto = jax.grad(partial(loss, auto), argnums=(0, 1))(*args)
    g_cust = jax.grad(partial(loss, cust), argnums=(0, 1))(*args)
    for name, a, b in zip(("volume", "tf_lut"), g_auto, g_cust):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=3e-3 * scale, rtol=2e-2, err_msg=name)
    assert np.abs(np.asarray(g_auto[0])).max() > 0


def test_step_planes_ladder():
    """Step-size -> plane-count mapping: the reference sweep at 256³ maps
    to real sampling-rate changes (VERDICT r3 item 3), and the slab-native
    step (1/N) maps to the identity."""
    assert slab.step_planes(1.0 / 256.0, 256) == 256
    assert slab.step_planes(0.003, 256) == 256
    assert slab.step_planes(0.005, 256) == 256
    assert slab.step_planes(0.010, 256) == 128
    assert slab.step_planes(0.020, 256) == 64
    assert slab.step_planes(0.001, 256) == 1024
    assert slab.step_planes(0.0, 256) == 256  # disabled -> native
    # smoothing clamps supersampling, keeps subsampling
    p_smooth = RenderParams(use_gaussian_smoothing=True, raymarching_step_size=0.001)
    assert slab.resolve_planes(p_smooth, 256) == 256
    p_sub = RenderParams(use_gaussian_smoothing=True, raymarching_step_size=0.02)
    assert slab.resolve_planes(p_sub, 256) == 64


def test_slab_resample_identity_and_structure():
    rng = np.random.default_rng(5)
    vol = jnp.asarray(rng.random((8, 4, 4), np.float32))
    assert slab.slab_resample(vol, 8) is vol
    up = np.asarray(slab.slab_resample(vol, 16))
    v = np.asarray(vol)
    # plane q of the upsample sits at source coordinate (q+0.5)/2 - 0.5
    np.testing.assert_allclose(up[0], v[0], atol=1e-6)  # clamped edge
    np.testing.assert_allclose(up[1], 0.75 * v[0] + 0.25 * v[1], atol=1e-6)
    np.testing.assert_allclose(up[2], 0.25 * v[0] + 0.75 * v[1], atol=1e-6)
    down = np.asarray(slab.slab_resample(vol, 4))
    np.testing.assert_allclose(down[0], 0.5 * (v[0] + v[1]), atol=1e-6)
    near = np.asarray(slab.slab_resample_nearest(vol, 4))
    # s = (q+0.5)*2 - 0.5 = {0.5, 2.5, ...} -> round-half-up picks 1, 3, ...
    np.testing.assert_allclose(near[0], v[1], atol=0)


def test_step_size_changes_slab_render(scene, cam):
    """The slab renderer's step-size knob is real: a coarser step renders
    a (slightly) different, cheaper image; the gradient still flows to the
    source volume through the resample lerp."""
    m = cam.matrices()
    fine = PARAMS  # 0.05 at side 16 -> planes 16 (native)
    coarse = PARAMS.replace(raymarching_step_size=0.15)  # -> planes 8
    assert slab.resolve_planes(coarse, SIDE) == 8
    a = np.asarray(slab.render(scene, m, fine, RES, RES))
    b = np.asarray(slab.render(scene, m, coarse, RES, RES))
    assert np.abs(a - b).max() > 1e-3  # real sampling-rate change

    def loss(vol):
        from volym.scene import Scene as S

        s = S(volume=vol, importance=scene.importance, tf_lut=scene.tf_lut)
        img = slab.render_diff(s, m, coarse, RES, RES)
        return jnp.sum(img)

    g = np.asarray(jax.grad(loss)(scene.volume))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
