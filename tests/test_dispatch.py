"""One backend dispatch (``render/renderer.py``): the names it accepts, the
functions it picks, that every entry point goes through it, and that no
module chooses what to compute from the device it runs on."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from volym import Camera, RenderParams, Scene
from volym.parallel import mesh as pmesh
from volym.render import diff, fast, slab
from volym.render.renderer import BACKENDS, check_backend, make_renderer, render_fn

PACKAGE = Path(__file__).resolve().parent.parent / "volym"
REJECTED = ["pallas", "slab_triton", "SLAB", "", "gpu"]
PARAMS = RenderParams(
    use_gaussian_smoothing=False, use_shading=False, raymarching_step_size=0.05,
    adaptive_stepping=False,
)


@pytest.fixture(scope="module")
def scene():
    return Scene.synthetic("sphere", side=16)


@pytest.fixture(scope="module")
def cam():
    return Camera(aspect=1.0, distance=1.2).orbit(30.0, 20.0, 0.0).matrices()


def test_backends_are_ray_and_slab():
    assert BACKENDS == ("ray", "slab")


@pytest.mark.parametrize("name", BACKENDS)
def test_check_backend_accepts(name):
    assert check_backend(name) == name


@pytest.mark.parametrize("name", REJECTED)
def test_check_backend_rejects(name):
    with pytest.raises(ValueError, match="unknown renderer backend"):
        check_backend(name)


@pytest.mark.parametrize(
    "backend, differentiable, expected",
    [
        ("ray", False, fast.render),
        ("ray", True, diff.render),
        ("slab", False, slab.render),
        ("slab", True, slab.render_diff),
    ],
)
def test_render_fn_picks(backend, differentiable, expected):
    assert render_fn(backend, differentiable) is expected


@pytest.mark.parametrize("name", REJECTED[:2])
def test_entry_points_reject_unknown(scene, cam, name):
    with pytest.raises(ValueError):
        make_renderer(scene, PARAMS, 8, 8, backend=name)
    with pytest.raises(ValueError):
        pmesh.render_sharded(scene, cam, PARAMS, 8, 8, pmesh.make_mesh(), backend=name)
    with pytest.raises(ValueError):
        pmesh.make_train_step(PARAMS, 8, 8, pmesh.make_mesh(), backend=name, camera_matrices=cam)


def test_cli_offers_only_the_backends(capsys):
    from volym.cli import build_parser

    ap = build_parser()
    for name in BACKENDS:
        assert ap.parse_args(["screenshot", "--renderer", name]).renderer == name
    with pytest.raises(SystemExit):
        ap.parse_args(["screenshot", "--renderer", "pallas"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("backend", BACKENDS)
def test_make_renderer_with_mesh_shards_either_backend(scene, cam, backend):
    """A mesh shards the chosen backend: the image equals the unsharded
    render of that same backend."""
    sharded = make_renderer(scene, PARAMS, 8, 8, mesh=pmesh.make_mesh(), backend=backend)(cam)
    single = make_renderer(scene, PARAMS, 8, 8, backend=backend)(cam)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), atol=1e-5)


@pytest.mark.parametrize("differentiable", [False, True])
def test_make_renderer_slab_matches_slab_module(scene, cam, differentiable):
    img = make_renderer(scene, PARAMS, 8, 8, backend="slab", differentiable=differentiable)(cam)
    np.testing.assert_allclose(np.asarray(img), np.asarray(slab.render(scene, cam, PARAMS, 8, 8)), atol=1e-6)


def _platform_branches(path: Path) -> list[str]:
    """Calls of ``default_backend()`` and reads of ``.platform`` /
    ``.device_kind`` in a module."""
    hits = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute) and node.attr in ("platform", "device_kind", "default_backend"):
            hits.append(f"{path.name}:{node.lineno} .{node.attr}")
    return hits


def test_no_module_selects_by_platform():
    modules = sorted(PACKAGE.rglob("*.py"))
    assert len(modules) > 20
    assert [hit for m in modules for hit in _platform_branches(m)] == []


def test_platform_scan_finds_a_branch(tmp_path):
    """The scan above is live: it flags the pattern the removed code used."""
    p = tmp_path / "m.py"
    p.write_text("import jax\nif jax.default_backend() == 'gpu':\n    x = jax.devices()[0].platform\n")
    assert len(_platform_branches(p)) == 2


def test_first_hit_slab_train_step_rejected(cam):
    with pytest.raises(NotImplementedError):
        pmesh.make_train_step(
            PARAMS.replace(use_opacity=False), 8, 8, pmesh.make_mesh(), backend="slab",
            camera_matrices=cam,
        )


def test_slab_train_step_needs_camera():
    with pytest.raises(ValueError, match="camera_matrices"):
        pmesh.make_train_step(PARAMS, 8, 8, pmesh.make_mesh(), backend="slab")


def test_render_params_drop_kernel_only_fields():
    for field in ("u8_volume", "fast_math", "camera_grads"):
        assert not hasattr(RenderParams(), field)
    with pytest.raises(TypeError):
        RenderParams(u8_volume=True)


def test_opaque_sample_gradient_is_finite():
    """A LUT alpha of exactly 1 at a step under 0.01 (exponent < 1) keeps
    gradients finite: the opacity correction's derivative is cut at a = 1."""
    import jax

    from volym.transfer_function import corrected_alpha

    a = jnp.asarray([0.0, 0.5, 0.999, 1.0], jnp.float32)
    val, grad = jax.value_and_grad(lambda a: jnp.sum(corrected_alpha(a, 0.4)))(a)
    assert np.isfinite(np.asarray(grad)).all()
    np.testing.assert_allclose(
        np.asarray(corrected_alpha(a, 0.4)), 1.0 - (1.0 - np.asarray(a)) ** 0.4, atol=1e-6
    )
    assert float(grad[3]) == 0.0 and float(grad[1]) > 0
