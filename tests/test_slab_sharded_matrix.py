"""The slab path sharded over the 8-device CPU mesh, 1D (``make_mesh``) and
2D (``make_host_mesh``): the forward and the train step equal the
single-device result in every mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import slab_oracle as so
from volym.parallel import mesh as pmesh
from volym.render import slab

MESHES = {"rays": pmesh.make_mesh, "host_rays": pmesh.make_host_mesh}
DIRECTION = "+z"


@pytest.mark.parametrize("mode", list(so.MODES))
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sharded_forward_matches_single(mesh_kind, mode):
    sc = so.scene(mode)
    m = so.camera(DIRECTION).matrices()
    p = so.params(mode)
    mesh = MESHES[mesh_kind]()
    assert mesh.devices.size == 8
    a = np.asarray(pmesh.render_sharded(sc, m, p, so.RES, so.RES, mesh, backend="slab"))
    b = np.asarray(slab.render(sc, m, p, so.RES, so.RES))
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize("mode", so.DIFF_MODES)
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_sharded_train_step_matches_single(mesh_kind, mode):
    """Loss and psum'd gradients of the sharded step equal value_and_grad
    of the single-device replay VJP."""
    sc = so.scene(mode)
    m = so.camera(DIRECTION).matrices()
    p = so.params(mode)
    target = jnp.asarray(slab.render(sc, m, p, so.RES, so.RES)) * 0.8
    step = pmesh.make_train_step(
        p, so.RES, so.RES, MESHES[mesh_kind](), backend="slab", camera_matrices=m
    )
    loss, grads = step(sc, m, target)

    def loss_single(s):
        return jnp.mean((slab.render_diff(s, m, p, so.RES, so.RES) - target) ** 2)

    loss_ref, grads_ref = jax.value_and_grad(loss_single)(sc)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    assert float(loss_ref) > 0
    for name in ("volume", "importance", "tf_lut"):
        a = np.asarray(getattr(grads_ref, name))
        b = np.asarray(getattr(grads, name))
        scale = max(np.abs(a).max(), 1e-9)
        np.testing.assert_allclose(b, a, atol=1e-5 * scale, rtol=1e-4, err_msg=name)
