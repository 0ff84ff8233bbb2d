"""Independent scalar oracle: a literal per-pixel NumPy transcription of the
reference ray-march kernel (``shaders/importance_driven_volume_rendering.wgsl``
lines 213-330), with real ``continue``/``break`` control flow.

Deliberately written as naive Python loops, sharing no code with
``volym`` — it exists to catch vectorisation/masking mistakes in the
golden ``lax.scan`` renderer (SURVEY.md section 4 item 1).
"""

from __future__ import annotations

import math

import numpy as np

GAUSSIAN_KERNEL_SIZE = 2
GAUSSIAN_STEP = 0.005
GAUSSIAN_SIGMA = 1.5
CONE_SAMPLES = 8
CONE_ANGLE = 0.2


def sample_nearest(grid, p):
    n = np.array([grid.shape[2], grid.shape[1], grid.shape[0]], np.float32)
    i = np.clip(np.floor(np.asarray(p, np.float32) * n), 0, n - 1).astype(int)
    return float(grid[i[2], i[1], i[0]])


def sample_trilinear(grid, p):
    n = np.array([grid.shape[2], grid.shape[1], grid.shape[0]], np.float32)
    c = np.asarray(p, np.float32) * n - 0.5
    i0f = np.floor(c)
    t = c - i0f
    i0 = np.clip(i0f, 0, n - 1).astype(int)
    i1 = np.clip(i0f + 1, 0, n - 1).astype(int)
    out = 0.0
    for dz, wz in ((0, 1 - t[2]), (1, t[2])):
        for dy, wy in ((0, 1 - t[1]), (1, t[1])):
            for dx, wx in ((0, 1 - t[0]), (1, t[0])):
                zi = i1[2] if dz else i0[2]
                yi = i1[1] if dy else i0[1]
                xi = i1[0] if dx else i0[0]
                out += float(grid[zi, yi, xi]) * wz * wy * wx
    return out


def lut_sample(lut, d):
    n = lut.shape[0]
    c = d * n - 0.5
    i0 = int(np.clip(math.floor(c), 0, n - 1))
    i1 = min(i0 + 1, n - 1)
    t = min(max(c - i0, 0.0), 1.0)
    return lut[i0] * (1 - t) + lut[i1] * t


def sample_volume_smoothed(vol, pos, ray_dir, sigma, sample_fn):
    total, wsum = 0.0, 0.0
    for i in range(-GAUSSIAN_KERNEL_SIZE, GAUSSIAN_KERNEL_SIZE + 1):
        off = i * GAUSSIAN_STEP
        sp = pos + ray_dir * off
        if np.any(sp < 0.0) or np.any(sp > 1.0):
            continue
        w = math.exp(-(off * off) / (2 * sigma * sigma))
        total += sample_fn(vol, sp) * w
        wsum += w
    return total / wsum if wsum > 0 else 0.0


def importance_to_color(imp):
    return np.array([min(imp * 1.5, 1.0), (1.0 - imp) * 1.2, 0.2, imp], np.float32)


def cone_direction(main, s):
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(main, up)
    right = right / np.linalg.norm(right)
    new_up = np.cross(main, right)
    angle = (s / CONE_SAMPLES) * 2.0 * 3.14159
    d = main + right * math.cos(angle) * CONE_ANGLE + new_up * math.sin(angle) * CONE_ANGLE
    return d / np.linalg.norm(d)


def has_important_ahead_straight(imp_grid, pos, ray_dir, max_dist, steps):
    step = (max_dist - np.linalg.norm(pos)) / steps
    p = pos.copy()
    for _ in range(steps):
        p = p + ray_dir * step
        if sample_nearest(imp_grid, p) >= 0.5:
            return True
    return False


def has_important_ahead_cone(imp_grid, pos, ray_dir, max_dist, steps):
    step = (max_dist - np.linalg.norm(pos)) / steps
    for s in range(CONE_SAMPLES):
        d = cone_direction(ray_dir, s)
        p = pos.copy()
        for _ in range(steps):
            p = p + d * step
            if np.any(p < 0.0) or np.any(p > 1.0):
                break
            if sample_nearest(imp_grid, p) >= 0.5:
                return True
    return False


def ray_box(origin, d):
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (0.0 - origin) / d
        t2 = (1.0 - origin) / d
    tmin = np.minimum(t1, t2)
    tmax = np.maximum(t1, t2)
    return (
        np.float32(max(np.float32(np.max(tmin)), np.float32(0.0))),
        np.float32(max(np.float32(np.min(tmax)), np.float32(0.0))),
    )


def compute_gradient(vol, p, sample_fn):
    eps = 0.01
    g = np.zeros(3, np.float32)
    for a in range(3):
        off = np.zeros(3, np.float32)
        off[a] = eps
        g[a] = (sample_fn(vol, p + off) - sample_fn(vol, p - off)) / (2 * eps)
    return g


def blinn_phong(vol, p, color, cam_pos, sample_fn):
    g = compute_gradient(vol, p, sample_fn)
    gn = np.linalg.norm(g)
    if gn <= 0.0:
        return color
    n = g / gn
    light = np.array([1.0, 1.0, 1.0])
    light = light / np.linalg.norm(light)
    eye = cam_pos - p
    eye = eye / np.linalg.norm(eye)
    half = eye + light
    half = half / np.linalg.norm(half)
    diffuse = max(0.0, float(n @ light))
    spec = max(0.0, float(half @ n)) ** 24.0
    return color * (0.2 + 0.7 * diffuse) + 0.4 * spec


def render_scalar(volume, importance, lut, cam, params, height, width):
    """Render (H, W, 4) with literal per-pixel loops.

    ``cam`` is a volym Camera; ``params`` a RenderParams.  Uses the same
    matrix builders (already unit-tested against cgmath conventions) but a
    fully independent march.
    """
    m = cam.matrices()
    # float32 like the WGSL kernel (and the golden renderer): the march is
    # knife-edge sensitive at voxel boundaries (nearest sampling + central
    # differences), so the oracle must use the same precision.
    ivp = np.asarray(m.inverse_view_proj, np.float32)
    cam_pos = np.asarray(m.position, np.float32)
    sample_fn = sample_nearest if params.interpolation.value == "nearest" else sample_trilinear

    img = np.zeros((height, width, 4), np.float32)
    for py in range(height):
        for px in range(width):
            u, v = np.float32(px / width), np.float32(py / height)
            ndc = np.array([u * 2 - 1, 1 - v * 2, 0.0, 1.0], np.float32)
            world = ivp @ ndc
            d = world[:3] / world[3] - cam_pos
            d = (d / np.float32(np.linalg.norm(d.astype(np.float32)))).astype(np.float32)
            entry, exit_ = ray_box(cam_pos, d)
            if exit_ <= entry:
                img[py, px] = (0, 0, 0, 1)
                continue

            base = np.float32(params.raymarching_step_size)
            min_step = np.float32(base * 0.25)
            step = base
            acc_c = np.zeros(3, np.float32)
            acc_a = np.float32(0.0)
            t = np.float32(entry)
            while t < exit_ and acc_a < 0.95:
                pos = cam_pos + d * t
                if params.use_gaussian_smoothing:
                    density = sample_volume_smoothed(volume, pos, d, GAUSSIAN_SIGMA, sample_fn)
                else:
                    density = sample_fn(volume, pos)
                imp = sample_nearest(importance, pos)

                if params.adaptive_stepping:
                    if density >= params.density_threshold:
                        step = min_step
                    else:
                        step = min(base, step * 1.5)
                else:
                    step = base

                if density < params.density_threshold:
                    t += step
                    continue

                use_alpha = params.use_opacity
                if params.use_importance_coloring:
                    ca = importance_to_color(imp)
                    use_alpha = True
                else:
                    if params.use_importance_rendering:
                        if params.use_cone_importance_check:
                            ahead = has_important_ahead_cone(
                                importance, pos, d, exit_, params.importance_check_ahead_steps
                            )
                        else:
                            ahead = has_important_ahead_straight(
                                importance, pos, d, exit_, params.importance_check_ahead_steps
                            )
                        if imp < 1.0 and ahead:
                            t += step
                            continue
                    ca = lut_sample(lut, density)

                if params.use_shading:
                    shaded = blinn_phong(volume, pos, ca[:3].astype(np.float32), cam_pos, sample_fn)
                else:
                    shaded = ca[:3]

                if use_alpha:
                    alpha = 1.0 - (1.0 - ca[3]) ** (step * 100.0)
                    contrib = (1.0 - acc_a) * alpha
                    acc_c = acc_c + np.asarray(shaded) * contrib
                    acc_a += contrib
                else:
                    acc_c = np.asarray(shaded, np.float32)
                    acc_a = 1.0
                    break

                t += step
            img[py, px] = (*acc_c, acc_a)
    return img
