"""Independent per-pixel NumPy oracle for the slab march (python loops).

Every render mode of ``volym.render.slab``: plain and first-hit
compositing, importance coloring, Blinn-Phong shading from the
precomputed gradient field, Gaussian smoothing as the slab stencil, and
the straight and cone importance look-ahead in their continuum-limit
formulation.  Trilinear samples are bilinear inside the crossed plane;
nearest samples pick the closest texel.  Coordinates are clamped and
snapped to ``params.subtexel_bits`` like the sampler they model.  It works
at the native plane count only (``resolve_planes == side``).
"""

from __future__ import annotations

import math

import numpy as np

from volym.render import slab

GAUSSIAN_KERNEL_SIZE = 2
GAUSSIAN_STEP = 0.005
GAUSSIAN_SIGMA = 1.5
CONE_SAMPLES = 8
CONE_ANGLE = 0.2
LIGHT = np.ones(3) / math.sqrt(3.0)
AMBIENT, DIFFUSE, SPECULAR, SHININESS = 0.2, 0.7, 0.4, 24.0
GRADIENT_OFFSET = 0.01
# slab-axis layout: (transpose of a (z, y, x) grid, row component, column
# component), components in shader order x=0, y=1, z=2
LAYOUT = {2: ((0, 1, 2), 1, 0), 1: ((1, 0, 2), 2, 0), 0: ((2, 1, 0), 1, 2)}


def gradient_field(vol):
    """(3, D, H, W) central differences of the trilinear field at
    +-GRADIENT_OFFSET along each shader axis, clamp-to-edge."""
    n = vol.shape[0]
    off = GRADIENT_OFFSET * n
    lo = int(math.floor(off))
    frac = off - lo
    idx = np.arange(n)

    def shifted(axis, by):
        return np.take(vol, np.clip(idx + by, 0, n - 1), axis=axis)

    out = []
    for comp in range(3):
        axis = 2 - comp
        plus = shifted(axis, lo) * (1 - frac) + shifted(axis, lo + 1) * frac
        minus = shifted(axis, -lo) * (1 - frac) + shifted(axis, -lo - 1) * frac
        out.append((plus - minus) / (2.0 * GRADIENT_OFFSET))
    return np.stack(out)


def _snap(c, bits):
    return slab.snap_np(c, bits)


def _bilinear(sl, rc, cc, bits):
    rc = _snap(min(max(rc, 0.0), sl.shape[0] - 1.0), bits)
    cc = _snap(min(max(cc, 0.0), sl.shape[1] - 1.0), bits)
    r0, c0 = int(np.floor(rc)), int(np.floor(cc))
    r1, c1 = min(r0 + 1, sl.shape[0] - 1), min(c0 + 1, sl.shape[1] - 1)
    tr, tc = rc - r0, cc - c0
    return (
        sl[r0, c0] * (1 - tr) * (1 - tc) + sl[r0, c1] * (1 - tr) * tc
        + sl[r1, c0] * tr * (1 - tc) + sl[r1, c1] * tr * tc
    )


def _nearest(sl, rc, cc, bits):
    rc = _snap(min(max(rc, 0.0), sl.shape[0] - 1.0), bits)
    cc = _snap(min(max(cc, 0.0), sl.shape[1] - 1.0), bits)
    r = int(np.clip(np.floor(rc + 0.5), 0, sl.shape[0] - 1))
    c = int(np.clip(np.floor(cc + 0.5), 0, sl.shape[1] - 1))
    return sl[r, c]


def _lut(lut, dens):
    c = min(max(dens * lut.shape[0] - 0.5, 0.0), lut.shape[0] - 1.0)
    i0 = int(math.floor(c))
    i1 = min(i0 + 1, lut.shape[0] - 1)
    return lut[i0] * (1 - (c - i0)) + lut[i1] * (c - i0)


def _imp_color(imp):
    return np.array([min(imp * 1.5, 1.0), (1.0 - imp) * 1.2, 0.2, imp])


def _cone_dirs(d):
    right = np.cross(d, np.array([0.0, 1.0, 0.0]))
    right = right / max(np.linalg.norm(right), 1e-12)
    up = np.cross(d, right)
    out = []
    for s in range(CONE_SAMPLES):
        a = (s / CONE_SAMPLES) * 2.0 * 3.14159
        v = d + right * math.cos(a) * CONE_ANGLE + up * math.sin(a) * CONE_ANGLE
        out.append(v / np.linalg.norm(v))
    return out


def render(vol, imp, lut, cam, params, height, width):
    """(H, W, 4) slab-march image of ``vol`` / ``imp`` (z, y, x grids)."""
    m = cam.matrices()
    major, sign = slab.dominant_axis(m)
    order, rcomp, ccomp = LAYOUT[major]
    ivp = np.asarray(m.inverse_view_proj, np.float32)
    cp = np.asarray(m.position, np.float32)
    n = vol.shape[0]
    bits = params.subtexel_bits
    sample = _bilinear if params.interpolation.value == "trilinear" else _nearest
    vol_p = np.transpose(vol, order)
    imp_p = np.transpose(imp, order)
    grad_p = np.stack([np.transpose(g, order) for g in gradient_field(vol)])
    ks = list(range(n)) if sign > 0 else list(range(n - 1, -1, -1))
    lookahead = params.use_importance_rendering and not params.use_importance_coloring
    first_hit = not (params.use_opacity or params.use_importance_coloring)

    img = np.zeros((height, width, 4), np.float32)
    for py in range(height):
        for px in range(width):
            ndc = np.array([px / width * 2 - 1, 1 - py / height * 2, 0, 1], np.float32)
            world = ivp @ ndc
            d = world[:3] / world[3] - cp
            d = d / np.linalg.norm(d)
            with np.errstate(divide="ignore"):
                t1, t2 = (0 - cp) / d, (1 - cp) / d
            entry = max(float(np.max(np.minimum(t1, t2))), 0.0)
            exit_ = max(float(np.min(np.maximum(t1, t2))), 0.0)
            if exit_ <= entry:
                img[py, px] = (0, 0, 0, 1)
                continue
            if d[major] * sign <= 0:
                continue
            dt = (1.0 / n) / abs(d[major])
            ts = [((k + 0.5) / n - cp[major]) / d[major] for k in ks]

            def coords(t, dd=d):
                return (cp[rcomp] + t * dd[rcomp]) * n - 0.5, (cp[ccomp] + t * dd[ccomp]) * n - 0.5

            plain = [sample(vol_p[k], *coords(t), bits) for k, t in zip(ks, ts)]
            dens_at = plain
            if params.use_gaussian_smoothing:
                dens_at = []
                for mi in range(n):
                    rc, cc = coords(ts[mi])
                    total = wsum = 0.0
                    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
                        delta = i * GAUSSIAN_STEP
                        w = math.exp(-(delta**2) / (2 * GAUSSIAN_SIGMA**2))
                        u = delta / dt
                        rt = rc + u * dt * d[rcomp] * n
                        ct = cc + u * dt * d[ccomp] * n
                        if not (-0.5 <= rt <= n - 0.5 and -0.5 <= ct <= n - 0.5 and -0.5 <= mi + u <= n - 0.5):
                            continue
                        tap = 0.0
                        for o in range(-slab.SMOOTH_HALO, slab.SMOOTH_HALO + 1):
                            if sample is _bilinear:
                                ker = max(0.0, 1.0 - abs(u - o))
                            else:
                                ker = 1.0 if -0.5 <= u - o < 0.5 else 0.0
                            if ker:
                                tap += ker * plain[min(max(mi + o, 0), n - 1)]
                        total += w * tap
                        wsum += w
                    dens_at.append(total / wsum if wsum > 0 else 0.0)

            ahead = [False] * n
            if lookahead:
                d_range = [exit_ - np.linalg.norm(cp + t * d) for t in ts]
                if params.use_cone_importance_check:
                    fams = []
                    for dc in _cone_dirs(d.astype(np.float64)):
                        tcs = [((k + 0.5) / n - cp[major]) / dc[major] for k in ks]
                        hit = []
                        for k, tc in zip(ks, tcs):
                            rc, cc = coords(tc, dc)
                            inbox = -0.5 <= rc <= n - 0.5 and -0.5 <= cc <= n - 0.5
                            hit.append(inbox and tc > 0 and _nearest(imp_p[k], rc, cc, bits) >= 0.5)
                        fams.append((hit, dc[major] * n * sign))
                else:
                    hit = [
                        entry <= t < exit_ and _nearest(imp_p[k], *coords(t), bits) >= 0.5
                        for k, t in zip(ks, ts)
                    ]
                    fams = [(hit, 1.0 / dt)]
                for hit, rate in fams:
                    if rate <= 0:
                        continue
                    nxt = [np.inf] * (n + 1)
                    for mi in reversed(range(n)):
                        nxt[mi] = mi if hit[mi] else nxt[mi + 1]
                    for mi in range(n):
                        ahead[mi] = ahead[mi] or nxt[mi + 1] <= mi + d_range[mi] * rate

            half = -d + LIGHT
            half = half / np.linalg.norm(half)
            acc_c, acc_a = np.zeros(3), 0.0
            for mi, (k, t) in enumerate(zip(ks, ts)):
                if not (entry <= t < exit_) or acc_a >= params.early_termination_alpha:
                    continue
                dens = dens_at[mi]
                if dens < params.density_threshold:
                    continue
                rc, cc = coords(t)
                imp_here = _nearest(imp_p[k], rc, cc, bits)
                if lookahead and imp_here < 1.0 and ahead[mi]:
                    continue
                rgba = _imp_color(imp_here) if params.use_importance_coloring else _lut(lut, dens)
                rgb = rgba[:3]
                if params.use_shading:
                    g = np.array([sample(grad_p[c][k], rc, cc, bits) for c in range(3)])
                    if g @ g > 0:
                        nrm = g / np.linalg.norm(g)
                        diff = max(0.0, nrm @ LIGHT)
                        spec = max(0.0, half @ nrm) ** SHININESS
                        rgb = rgb * (AMBIENT + DIFFUSE * diff) + SPECULAR * spec
                if first_hit:
                    acc_c, acc_a = rgb, 1.0
                    continue
                alpha = 1.0 - (1.0 - rgba[3]) ** (dt * 100.0)
                w = (1.0 - acc_a) * alpha
                acc_c = acc_c + rgb * w
                acc_a += w
            img[py, px] = (*acc_c, acc_a)
    return img


def mismatch_share(got, expect, atol=2e-3):
    """Share of pixels whose largest channel error exceeds ``atol``: the
    threshold knife-edges, where the oracle's float64 coordinates and the
    renderer's float32 ones land on opposite sides of the threshold."""
    err = np.abs(np.asarray(got) - expect).max(-1)
    return float((err > atol).mean()), float(err.max())


# ---- the mode x interpolation x march-direction matrix ---------------------

#: orbit angles (horizontal, vertical) whose camera marches along each axis
#: in each sense: "+x" marches toward +x, i.e. ``dominant_axis == (0, +1)``
DIRECTIONS = {
    "-x": (135.0, -20.0),
    "+x": (225.0, -20.0),
    "-y": (225.0, 50.0),
    "+y": (225.0, -50.0),
    "-z": (330.0, -20.0),
    "+z": (210.0, -20.0),
}
AXES = {"x": 0, "y": 1, "z": 2}

MODES = {
    "base": {},
    "first_hit": dict(use_opacity=False),
    "coloring": dict(use_importance_coloring=True),
    "shading": dict(use_shading=True),
    "coloring_shading": dict(use_importance_coloring=True, use_shading=True),
    "smoothing": dict(use_gaussian_smoothing=True),
    "smoothing_shading": dict(use_gaussian_smoothing=True, use_shading=True),
    "lookahead": dict(use_importance_rendering=True),
    "lookahead_cone": dict(use_importance_rendering=True, use_cone_importance_check=True),
    "lookahead_shaded": dict(use_importance_rendering=True, use_shading=True),
}
#: modes with gradients (first-hit is piecewise constant)
DIFF_MODES = [m for m in MODES if m != "first_hit"]
INTERPOLATIONS = ("trilinear", "nearest")
SIDE = 16
RES = 8


def camera(direction: str):
    from volym import Camera

    h, v = DIRECTIONS[direction]
    return Camera(aspect=1.0, distance=1.2).orbit(h, v, 0.0)


def expected_axis(direction: str) -> tuple[int, int]:
    return AXES[direction[1]], 1 if direction[0] == "+" else -1


def params(mode: str, interpolation: str = "trilinear"):
    from volym import RenderParams

    # step 0.05 at side 16 maps to the native 16 planes
    kw = dict(use_gaussian_smoothing=False, use_shading=False)
    kw.update(MODES[mode])
    return RenderParams(
        raymarching_step_size=0.05,
        adaptive_stepping=False,
        interpolation=interpolation,
        **kw,
    )


_SCENES = {}


def scene(mode: str):
    """16^3 test scene.  The look-ahead modes get a uniform haze with an
    important dense band (so the skip engages from every side); the rest
    get a soft sphere whose core is important (so coloring varies)."""
    import jax.numpy as jnp

    from volym import Scene

    kind = "band" if mode.startswith("lookahead") else "sphere"
    if kind not in _SCENES:
        sph = Scene.synthetic("sphere", side=SIDE)
        if kind == "sphere":
            imp = (np.asarray(sph.volume) > 0.8).astype(np.float32)
            _SCENES[kind] = Scene(volume=sph.volume, importance=jnp.asarray(imp), tf_lut=sph.tf_lut)
        else:
            vol = np.full((SIDE,) * 3, 0.45, np.float32)
            imp = np.zeros_like(vol)
            vol[10:13, 4:12, 4:12] = 0.9
            imp[10:13, 4:12, 4:12] = 1.0
            _SCENES[kind] = Scene(
                volume=jnp.asarray(vol), importance=jnp.asarray(imp), tf_lut=sph.tf_lut
            )
    return _SCENES[kind]


def oracle_image(mode: str, interpolation: str, direction: str, height=RES, width=RES):
    sc = scene(mode)
    return render(
        np.asarray(sc.volume), np.asarray(sc.importance), np.asarray(sc.tf_lut),
        camera(direction), params(mode, interpolation), height, width,
    )
