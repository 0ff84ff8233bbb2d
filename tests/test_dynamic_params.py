"""Traced float knobs: parameter sweeps must not recompile.

The reference re-uploads a uniform buffer per frame when the GUI mutates
parameters (``src/gpu_resources/parameters.rs:68-83``); the analog here is
:meth:`RenderParams.split_dynamic` — threshold / step size / early alpha /
ahead steps travel as a traced vector, so the benchmark sweep (and live
mutation) reuses one compilation per boolean-flag combination.
"""

import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym.render import fast, golden


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("sphere", side=16)


@pytest.fixture(scope="module")
def cam():
    return Camera(aspect=1.0, distance=1.2).orbit(30.0, 20.0, 0.0)


BASE = RenderParams(
    use_gaussian_smoothing=False,
    raymarching_step_size=0.05,
    interpolation="trilinear",
    use_shading=False,
)
RES = 8


def test_float_sweep_compiles_once(scene, cam):
    m = cam.matrices()
    start = fast._render_jit._cache_size()
    sweep = [
        BASE,
        BASE.replace(raymarching_step_size=0.02),
        BASE.replace(raymarching_step_size=0.1),
        BASE.replace(density_threshold=0.3),
        BASE.replace(early_termination_alpha=0.8),
        BASE.replace(importance_check_ahead_steps=20),
    ]
    for p in sweep:
        fast.render(scene, m, p, RES, RES)
    assert fast._render_jit._cache_size() - start == 1

    # a boolean-flag change is a new compilation, as designed
    fast.render(scene, m, BASE.replace(use_shading=True), RES, RES)
    assert fast._render_jit._cache_size() - start == 2


def test_full_reference_sweep_compile_budget(scene, cam):
    """The whole benchmark sweep (4 steps x {base, 3x imp, 3x cone}) needs
    at most one compilation per algorithm (VERDICT round-1 item 6)."""
    from volym.bench import harness

    m = cam.matrices()
    start = fast._render_jit._cache_size()
    base = BASE.replace(density_threshold=0.15)
    for step in harness.STEP_SIZES:
        fast.render(scene, m, base.replace(raymarching_step_size=step), RES, RES)
        for ahead in harness.IMPORTANCE_STEPS:
            for cone in (False, True):
                fast.render(
                    scene,
                    m,
                    base.replace(
                        raymarching_step_size=step,
                        importance_check_ahead_steps=ahead,
                        use_importance_rendering=True,
                        use_cone_importance_check=cone,
                    ),
                    RES,
                    RES,
                )
    assert fast._render_jit._cache_size() - start <= 3


def test_dynamic_path_matches_static_golden(scene, cam):
    """Traced-knob fast render == static golden scan, including traced
    ahead-steps (masked probe cap) and adaptive stepping."""
    m = cam.matrices()
    for p in [
        BASE,
        BASE.replace(density_threshold=0.25, raymarching_step_size=0.03),
        BASE.replace(use_importance_rendering=True, importance_check_ahead_steps=7),
        BASE.replace(
            use_importance_rendering=True,
            use_cone_importance_check=True,
            importance_check_ahead_steps=13,
        ),
        BASE.replace(adaptive_stepping=True, early_termination_alpha=0.9),
    ]:
        a = np.asarray(fast.render(scene, m, p, RES, RES))
        b = np.asarray(golden.render(scene, m, p, RES, RES))
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=str(p))


def test_slab_static_canonicalisation():
    a = RenderParams(raymarching_step_size=0.003, importance_check_ahead_steps=10)
    b = RenderParams(raymarching_step_size=0.02, importance_check_ahead_steps=20)
    assert a.slab_static() == b.slab_static()
    assert a.slab_static() != a.replace(use_shading=False).slab_static()
