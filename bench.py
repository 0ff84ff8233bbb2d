"""Benchmark: rays/s forward+backward on one GPU, bonsai 256^3 at 256x256.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}, ...}

value        = rays/s of the production differentiable path: one jitted
               ``value_and_grad`` step through ``slab.render_diff`` (the
               slab march with its replay VJP, plain jnp/lax compiled by
               XLA) returning dL/dvoxel + dL/dTF.
vs_baseline  = value / rays/s of the naive baseline implementation (plain
               JAX autodiff through the reference-parity t-step lax.scan
               renderer, measured on the same device at the SAME 256x256
               resolution).

Config (BASELINE.json configs 1 + 4): bonsai-class 256^3 uint8 volume
(synthetic stand-in, made from a seed), 256x256 rays, float32, trilinear
sampling, default TF, benchmark camera preset (threshold 0.15, smoothing
off — reference src/main.rs:180-190) at the reference's orbit distance
1.0, step 0.005 (256 slab planes; the t-step baseline takes the same
step).  Exits non-zero without a GPU: a CPU number is never reported
under this metric.
"""

from __future__ import annotations

import json
import sys

HEIGHT = WIDTH = 256
SIDE = 256
STEP = 0.005


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> int:
    from volym import compile_cache

    compile_cache.enable()
    import jax
    import jax.numpy as jnp

    from volym import Camera, RenderParams, Scene
    from volym.bench.harness import marginal_time
    from volym.render import golden, slab

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform}; refusing to benchmark")
        return 1
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")

    params = RenderParams(
        density_threshold=0.15,
        raymarching_step_size=STEP,
        use_gaussian_smoothing=False,
        interpolation="trilinear",
        adaptive_stepping=False,
        use_shading=False,
    )
    scene = Scene.synthetic("bonsai", side=SIDE)
    m = Camera(aspect=1.0, distance=1.0).orbit(30.0, 20.0, 0.0).matrices()

    def loss_prod(vol, lut):
        img = slab.render_diff(
            Scene(vol, scene.importance, lut), m, params, HEIGHT, WIDTH
        )
        return jnp.sum(img)

    prod_step = jax.jit(jax.value_and_grad(loss_prod, argnums=(0, 1)))
    t_prod = marginal_time(lambda: prod_step(scene.volume, scene.tf_lut), iters=30)
    rays_prod = HEIGHT * WIDTH / t_prod
    log(f"production fwd+bwd: {t_prod*1e3:.3f} ms/frame -> {rays_prod:,.0f} rays/s")

    def loss_base(s):
        return jnp.sum(golden.render(s, m, params, HEIGHT, WIDTH))

    base_step = jax.jit(jax.value_and_grad(loss_base))
    t_base = marginal_time(lambda: base_step(scene), iters=3, warmup=1)
    rays_base = HEIGHT * WIDTH / t_base
    log(f"baseline  fwd+bwd: {t_base*1e3:.3f} ms/frame -> {rays_base:,.0f} rays/s")

    print(json.dumps({
        "metric": "rays_per_s_fwd_bwd_bonsai256_256x256",
        "value": rays_prod,
        "unit": "rays/s",
        "vs_baseline": rays_prod / rays_base,
        "prod_ms_per_frame": t_prod * 1e3,
        "baseline_ms_per_frame": t_base * 1e3,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
