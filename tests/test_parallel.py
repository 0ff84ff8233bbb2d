"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY.md section 4 item 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym.parallel import mesh as pmesh
from volym.render import diff, golden

PARAMS = RenderParams(
    use_gaussian_smoothing=False,
    raymarching_step_size=0.1,
    max_steps=40,
    use_shading=False,
)
RES = 16


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("sphere", side=16)


@pytest.fixture(scope="module")
def cam():
    return Camera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single(scene, cam):
    m = cam.matrices()
    mesh = pmesh.make_mesh()
    img_sharded = np.asarray(pmesh.render_sharded(scene, m, PARAMS, RES, RES, mesh))
    img_single = np.asarray(golden.render(scene, m, PARAMS, RES, RES))
    assert (img_single[..., :3].max(-1) > 0.01).mean() > 0.05
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-6)


def test_sharded_render_rejects_uneven():
    mesh = pmesh.make_mesh()
    with pytest.raises(ValueError):
        pmesh.render_sharded(Scene.synthetic("sphere", 8), Camera().matrices(), PARAMS, 3, 3, mesh)


def test_sharded_diff_render_matches(scene, cam):
    m = cam.matrices()
    mesh = pmesh.make_mesh()
    a = np.asarray(
        pmesh.render_sharded(scene, m, PARAMS, RES, RES, mesh, differentiable=True)
    )
    b = np.asarray(diff.render(scene, m, PARAMS.replace(adaptive_stepping=False), RES, RES))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_train_step_grads_match_psum_of_local(scene, cam):
    """Sharded (loss, grads) must equal the unsharded differentiable step."""
    m = cam.matrices()
    mesh = pmesh.make_mesh()
    fixed = PARAMS.replace(adaptive_stepping=False)
    target = jnp.asarray(golden.render(scene, m, fixed, RES, RES)) * 0.8

    step = pmesh.make_train_step(PARAMS, RES, RES, mesh)
    loss_sharded, grads_sharded = step(scene, m, target)

    def loss_single(s):
        img = diff.render(s, m, fixed, RES, RES)
        return jnp.mean((img - target) ** 2)

    loss_ref, grads_ref = jax.value_and_grad(loss_single)(scene)

    np.testing.assert_allclose(float(loss_sharded), float(loss_ref), rtol=1e-5)
    assert float(loss_ref) > 0
    for name in ("volume", "importance", "tf_lut"):
        a = np.asarray(getattr(grads_ref, name))
        b = np.asarray(getattr(grads_sharded, name))
        scale = max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, rtol=1e-4, err_msg=name)
    assert np.abs(np.asarray(grads_ref.volume)).max() > 0


def test_sharded_slab_matches_single(scene, cam):
    from volym.render import slab

    m = cam.matrices()
    mesh = pmesh.make_mesh()
    params = PARAMS.replace(use_shading=False)
    a = np.asarray(pmesh.render_sharded(scene, m, params, RES, RES, mesh, backend="slab"))
    b = np.asarray(slab.render(scene, m, params, RES, RES))
    np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("backend", ["slab"])
@pytest.mark.parametrize("shading", [False, True])
def test_train_step_slab_backends(scene, cam, backend, shading):
    """Sharded slab train step: grads equal the unsharded slab replay
    (base and Blinn-Phong-shaded modes)."""
    from volym.render import slab

    m = cam.matrices()
    mesh = pmesh.make_mesh()
    fixed = PARAMS.replace(adaptive_stepping=False, use_shading=shading)
    target = jnp.asarray(slab.render(scene, m, fixed, RES, RES)) * 0.8

    step = pmesh.make_train_step(
        fixed, RES, RES, mesh, backend=backend, camera_matrices=m
    )
    loss_sharded, grads_sharded = step(scene, m, target)

    def loss_single(s):
        img = slab.render_diff(s, m, fixed, RES, RES)
        return jnp.mean((img - target) ** 2)

    loss_ref, grads_ref = jax.value_and_grad(loss_single)(scene)
    np.testing.assert_allclose(float(loss_sharded), float(loss_ref), rtol=1e-5)
    assert float(loss_ref) > 0
    for name in ("volume", "tf_lut"):
        a = np.asarray(getattr(grads_ref, name))
        b = np.asarray(getattr(grads_sharded, name))
        scale = max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, rtol=1e-4, err_msg=name)
    assert np.abs(np.asarray(grads_ref.volume)).max() > 0


def test_host_mesh_shape():
    mesh = pmesh.make_host_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("host", pmesh.RAY_AXIS)


def test_launch_env_parsing():
    from volym.parallel import launch

    assert launch.init_kwargs_from_env({}) == {}
    env = {
        launch.ENV_COORDINATOR: "host0:8476",
        launch.ENV_NUM_PROCESSES: "2",
        launch.ENV_PROCESS_ID: "1",
    }
    assert launch.init_kwargs_from_env(env) == {
        "coordinator_address": "host0:8476",
        "num_processes": 2,
        "process_id": 1,
    }
    assert not launch.wants_distributed(False, {})
    assert launch.wants_distributed(True, {})
    assert launch.wants_distributed(False, env)
    assert launch.wants_distributed(False, {launch.ENV_FORCE: "1"})


def test_scaling_table_on_virtual_mesh(scene, cam):
    """The scaling harness emits TrialResults-schema rows with efficiency."""
    from volym.bench import harness

    rows = harness.scaling_table(
        scene, cam.matrices(), PARAMS, RES, RES,
        device_counts=[1, 2, 8], num_trials=1, seconds=0.05,
        log=lambda *a: None,
    )
    assert [r["devices"] for r in rows] == [1, 2, 8]
    for r in rows:
        assert r["rays_per_s"] > 0
        assert r["scaling_efficiency"] > 0
        assert "avg_fps" in r and "std_dev_fps" in r
    assert rows[0]["scaling_efficiency"] == 1.0


def test_fit_distributed_loop_runs(scene, cam):
    """Host-mesh training loop: loss decreases over a few sharded steps."""
    import jax.numpy as jnp

    from volym.parallel import launch
    from volym.render import slab
    from volym.scene import Scene as S

    m = cam.matrices()
    fixed = PARAMS.replace(adaptive_stepping=False, use_shading=False)
    target = jnp.asarray(slab.render(scene, m, fixed, RES, RES))
    init = S(
        volume=jnp.full_like(scene.volume, 0.2),
        importance=scene.importance,
        tf_lut=scene.tf_lut,
    )
    fitted, losses = launch.fit_distributed(
        init, m, target, fixed, steps=5, lr=0.05, backend="slab",
    )
    assert losses[-1] < losses[0]

def _lookahead_scene():
    """16^3 haze + important dense band (mirrors tests/test_slab.py)."""
    side = 16
    vol = np.full((side, side, side), 0.45, np.float32)
    imp = np.zeros((side, side, side), np.float32)
    vol[10:13, 4:12, 4:12] = 0.9
    imp[10:13, 4:12, 4:12] = 1.0
    return Scene(
        volume=jnp.asarray(vol),
        importance=jnp.asarray(imp),
        tf_lut=Scene.synthetic("sphere", side=8).tf_lut,
    )


@pytest.mark.parametrize("backend", ["slab"])
@pytest.mark.parametrize(
    "mode",
    [
        "smoothing", "lookahead", "lookahead_cone", "smoothing_shading",
        "first_hit", "coloring_shading",
    ],
)
def test_sharded_slab_modes_match_single(cam, backend, mode):
    """Smoothing and importance look-ahead run sharded and match the
    single-device slab render exactly."""
    from volym.render import slab

    sc = _lookahead_scene()
    m = cam.matrices()
    mesh = pmesh.make_mesh()
    params = PARAMS.replace(
        use_gaussian_smoothing="smoothing" in mode,
        use_shading="shading" in mode,
        use_importance_rendering="lookahead" in mode,
        use_cone_importance_check="cone" in mode,
        use_importance_coloring="coloring" in mode,
        use_opacity="first_hit" not in mode,
    )
    a = np.asarray(
        pmesh.render_sharded(sc, m, params, RES, RES, mesh, backend=backend)
    )
    b = np.asarray(slab.render(sc, m, params, RES, RES))
    np.testing.assert_allclose(a, b, atol=1e-5)
    if "lookahead" in mode:  # the gate actually engaged
        base = np.asarray(slab.render(sc, m, PARAMS, RES, RES))
        assert np.abs(b - base).max() > 0.05


@pytest.mark.parametrize("backend", ["slab"])
@pytest.mark.parametrize("mode", ["smoothing", "lookahead"])
def test_train_step_slab_modes(cam, backend, mode):
    """Sharded slab train step under smoothing / look-ahead: grads equal
    the unsharded slab replay VJP."""
    from volym.render import slab

    sc = _lookahead_scene()
    m = cam.matrices()
    mesh = pmesh.make_mesh()
    fixed = PARAMS.replace(
        adaptive_stepping=False,
        use_gaussian_smoothing=mode == "smoothing",
        use_importance_rendering=mode == "lookahead",
    )
    target = jnp.asarray(slab.render(sc, m, fixed, RES, RES)) * 0.8
    step = pmesh.make_train_step(
        fixed, RES, RES, mesh, backend=backend, camera_matrices=m
    )
    loss_sharded, grads_sharded = step(sc, m, target)

    def loss_single(s):
        img = slab.render_diff(s, m, fixed, RES, RES)
        return jnp.mean((img - target) ** 2)

    loss_ref, grads_ref = jax.value_and_grad(loss_single)(sc)
    np.testing.assert_allclose(float(loss_sharded), float(loss_ref), rtol=1e-5)
    assert float(loss_ref) > 0
    for name in ("volume", "tf_lut"):
        a = np.asarray(getattr(grads_ref, name))
        b = np.asarray(getattr(grads_sharded, name))
        scale = max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, rtol=1e-4, err_msg=name)
    assert np.abs(np.asarray(grads_ref.volume)).max() > 0


def test_split_psum_hlo_schedule(scene, cam):
    """split_psum=True splits the tail tuple all-reduce (VERDICT r4 item 9):
    the small (importance, LUT) gradients reduce in their own all-reduce
    that the volume all-reduce depends on — so the combiner cannot merge
    them and the small reduction can overlap the volume backward.  Default
    stays fused (one combined gradient all-reduce)."""
    import re

    m = cam.matrices()
    mesh = pmesh.make_mesh()
    fixed = PARAMS.replace(adaptive_stepping=False)
    target = jnp.zeros((RES, RES, 4), jnp.float32)

    def hlo_for(split):
        step = pmesh.make_train_step(
            fixed, RES, RES, mesh, backend="slab", camera_matrices=m,
            split_psum=split,
        )
        return jax.jit(lambda s, c, t: step(s, c, t)).lower(
            scene, m, target
        ).compile().as_text()

    def ar_lines(hlo):
        return [
            l for l in hlo.splitlines()
            if " = " in l and "all-reduce(" in l
        ]

    fused, split = ar_lines(hlo_for(False)), ar_lines(hlo_for(True))
    vol_shape = "f32[16,16,16]"

    # default: ONE combined gradient all-reduce carrying the volume grad
    # together with the LUT grad (the measured-optimal fused tail reduce)
    fused_both = [l for l in fused if vol_shape in l and "f32[256,4]" in l]
    assert len(fused_both) == 1, fused
    # split: MORE all-reduces, and the volume grad reduces ALONE — a
    # non-tuple all-reduce whose line mentions exactly (result, operand)
    assert len(split) > len(fused), (fused, split)
    split_vol = [
        l for l in split
        if l.split(" all-reduce(")[0].count("f32[") == 1 and vol_shape in l
    ]
    assert len(split_vol) == 1, split
    # ...scheduled after the small all-reduce it depends on (HLO text is
    # def-before-use: the data dependency forces this ordering)
    small_idx = min(i for i, l in enumerate(split) if "f32[256,4]" in l)
    vol_idx = split.index(split_vol[0])
    assert small_idx < vol_idx, split

    # the split step still computes identical gradients
    step_f = pmesh.make_train_step(
        fixed, RES, RES, mesh, backend="slab", camera_matrices=m)
    step_s = pmesh.make_train_step(
        fixed, RES, RES, mesh, backend="slab", camera_matrices=m,
        split_psum=True)
    lf, gf = step_f(scene, m, target)
    ls, gs = step_s(scene, m, target)
    np.testing.assert_allclose(float(lf), float(ls), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(gf), jax.tree_util.tree_leaves(gs)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-8)
