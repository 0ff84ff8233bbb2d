"""Multi-device ray sharding and distributed training step.

The reference's only parallelism is SIMT over pixels inside one GPU
(16x16 workgroups, ``src/demos/pipeline.rs:83-87``).  The generalisation
to several devices (SURVEY.md section 2, "Parallelism & distributed
communication"): shard the pixel/ray axis over a ``jax.sharding.Mesh`` with
``shard_map``, replicate the voxel grid / TF / importance (256^3 uint8 is
16 MiB), and ``psum`` the parameter gradients across the ray axis.  XLA
hands the psum to NCCL as an all-reduce; the cards of one host are joined
all to all (NVLink), so the mesh follows the algorithm alone.

Mesh axes: a single ``"rays"`` axis is the default (pure data parallelism
over rays).  A 2D ``("host", "rays")`` layout is provided for multi-host
runs so that the gradient reduction runs inside each host first and
across the network last.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from volym.config import RenderParams
from volym.render import diff, golden
from volym.render import rays as rays_mod
from volym.render import slab as slab_mod
from volym.render.renderer import check_backend
from volym.scene import Scene

RAY_AXIS = "rays"


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    """1D device mesh over the ray axis."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def make_host_mesh(devices=None) -> Mesh:
    """(host, rays) mesh for multi-host runs: outer axis = process
    boundary (the network between hosts), inner = the devices of one
    host (NVLink, all to all)."""
    devices = jax.devices() if devices is None else list(devices)
    n_hosts = max(jax.process_count(), 1)
    per_host = len(devices) // n_hosts
    arr = np.asarray(devices).reshape(n_hosts, per_host)
    return Mesh(arr, ("host", RAY_AXIS))


def _ray_count(height: int, width: int, mesh: Mesh) -> int:
    n = int(np.prod(mesh.devices.shape))
    if (height * width) % n:
        raise ValueError(
            f"{height}x{width} rays do not divide evenly over {n} devices; "
            "pad the image height to a multiple of the mesh size"
        )
    return n


def _mesh_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def render_sharded(
    scene: Scene,
    camera_matrices,
    params: RenderParams,
    height: int,
    width: int,
    mesh: Mesh,
    differentiable: bool = False,
    backend: str = "ray",
):
    """Tile-sharded render: rays split across every mesh device, scene
    replicated, no communication in the forward pass.

    Ray generation is tiny (a few multiply-adds per pixel) and runs sharded
    too — each device builds only its own rays.  ``backend="slab"`` marches
    slab-ordered."""
    major = sign = planes = 0
    if check_backend(backend) == "slab":
        # same mode guard as slab.render_diff: first-hit (use_opacity=
        # False) renders forward-only — it is piecewise constant, so its
        # gradients need no backend at all (match render/diff.py)
        if differentiable and not (
            params.use_opacity or params.use_importance_coloring
        ):
            raise NotImplementedError(
                "the first-hit (use_opacity=False) mode is piecewise "
                "constant; differentiable rendering needs use_opacity=True"
            )
        # host-side static choice (camera matrices are host state)
        major, sign = slab_mod.dominant_axis(camera_matrices)
        # step-size mapping, identical to the single-device entries
        planes = slab_mod.resolve_planes(params, int(scene.volume.shape[0]))
    return _render_sharded_jit(
        scene, camera_matrices, params, height, width, mesh, differentiable,
        backend, major, sign, planes,
    )


def _slab_shard_march(scene, params, major, sign, planes, origin, dirs, entry, exit_, differentiable):
    """One shard's rays through the slab march (plain or replay-VJP)."""
    vol_perm = slab_mod.slab_resample(
        slab_mod.permute_volume(scene.volume, major), planes
    )
    imp_perm = slab_mod.slab_resample_nearest(
        slab_mod.permute_volume(scene.importance, major), planes
    )
    grad_perm = (
        slab_mod.slab_resample_grad(
            slab_mod.permute_gradient(
                slab_mod.gradient_volume(scene.volume), major
            ),
            planes,
        )
        if params.use_shading
        else None
    )
    if differentiable:
        return slab_mod.march_slabs_diff(
            params, major, sign, vol_perm, imp_perm, scene.tf_lut,
            origin, dirs, entry, jax.lax.stop_gradient(exit_), grad_perm,
        )
    return slab_mod.march_slabs(
        vol_perm, imp_perm, scene.tf_lut, origin, dirs, entry, exit_,
        major, sign, params, grad_perm,
    )


@partial(
    jax.jit,
    static_argnames=(
        "params", "height", "width", "mesh", "differentiable", "backend",
        "major", "sign", "planes",
    ),
)
def _render_sharded_jit(
    scene: Scene,
    camera_matrices,
    params: RenderParams,
    height: int,
    width: int,
    mesh: Mesh,
    differentiable: bool,
    backend: str,
    major: int,
    sign: int,
    planes: int = 0,
):
    _ray_count(height, width, mesh)
    axes = _mesh_axes(mesh)
    spec_r = P(axes)  # rays axis sharded over all mesh axes, flattened
    march = diff.march_fixed if differentiable else golden.march
    render_params = params.replace(adaptive_stepping=False) if differentiable else params

    def shard_fn(ndc):
        origin, dirs = _rays_from_ndc(camera_matrices, ndc)
        entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
        miss = exit_ <= entry
        if backend == "slab":
            img = _slab_shard_march(
                scene, render_params, major, sign, planes, origin, dirs,
                entry, exit_, differentiable,
            )
        elif differentiable:
            img = march(
                render_params,
                scene.volume,
                scene.importance,
                scene.tf_lut,
                origin,
                dirs,
                entry,
                jax.lax.stop_gradient(exit_),
                camera_matrices.position,
            )
        else:
            img = march(
                scene, origin, dirs, entry, exit_, camera_matrices.position, render_params
            )
        miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
        return jnp.where(miss[:, None], miss_color[None, :], img)

    ndc = rays_mod.pixel_ndc(height, width)
    img = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(spec_r,), out_specs=spec_r, check_vma=False
    )(ndc)
    return img.reshape(height, width, 4)


def _rays_from_ndc(camera_matrices, ndc):
    """Per-shard ray generation from precomputed NDC coords."""
    pos = rays_mod.unproject_ndc(camera_matrices, ndc)
    d = pos - camera_matrices.position[None, :]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return camera_matrices.position, d


def make_train_step(
    params: RenderParams,
    height: int,
    width: int,
    mesh: Mesh,
    backend: str = "ray",
    camera_matrices=None,
    split_psum: bool = False,
):
    """Distributed inverse-rendering step (BASELINE.json config 5).

    Returns ``step(scene, camera_matrices, target) -> (loss, grads)`` with
    rays sharded over the mesh and scene gradients psum'd across it.  By
    default XLA's all-reduce combiner merges the gradient psums into one
    tuple all-reduce at the end of the module.

    ``split_psum=True`` is the lever for a network-bound multi-host
    reduction (BASELINE north star: "grad allreduce overlapped with the
    backward"): the small, early-finishing gradients (TF LUT, importance)
    psum in their OWN all-reduce, which depends only on its own cotangents
    and can therefore be issued by the latency-hiding scheduler while the
    volume-grad scatter is still computing; a data dependency then pins
    the volume all-reduce after them, which keeps XLA's all-reduce combiner
    from fusing everything back into one tail tuple reduce.  The schedule
    split is asserted from the compiled HLO in
    ``tests/test_parallel.py::test_split_psum_hlo_schedule``.

    ``backend``: ``"ray"`` (t-step replay VJP) or ``"slab"`` (slab replay
    VJP).  The slab backend needs ``camera_matrices`` at factory time for
    the static dominant-axis choice (pass the training camera; the step
    itself still takes per-call matrices for pose refinement around it).
    """
    fixed = params.replace(adaptive_stepping=False)
    if not (params.use_opacity or params.use_importance_coloring):
        # same guard as render/diff.py:336 and slab.render_diff: the replay
        # VJPs reconstruct per-step transmittance from the alpha-compositing
        # identity, which does not hold for a first-hit forward — without
        # this they would return nonzero, meaningless gradients
        raise NotImplementedError(
            "the first-hit (use_opacity=False) mode is piecewise constant; "
            "differentiable rendering needs use_opacity=True"
        )
    _ray_count(height, width, mesh)
    axes = _mesh_axes(mesh)
    spec_r = P(axes)
    major = sign = 0
    if check_backend(backend) == "slab":
        if camera_matrices is None:
            raise ValueError("the slab train step needs camera_matrices")
        major, sign = slab_mod.dominant_axis(camera_matrices)

    def per_shard_loss(scene, camera_matrices, ndc, target_rows):
        origin, dirs = _rays_from_ndc(camera_matrices, ndc)
        entry, exit_ = rays_mod.ray_box_intersection(origin, dirs)
        miss = exit_ <= entry
        if backend == "slab":
            img = _slab_shard_march(
                scene, fixed, major, sign,
                slab_mod.resolve_planes(fixed, int(scene.volume.shape[0])),
                origin, dirs, entry, exit_, True,
            )
        else:
            img = diff.march_fixed(
                fixed,
                scene.volume,
                scene.importance,
                scene.tf_lut,
                origin,
                dirs,
                entry,
                jax.lax.stop_gradient(exit_),
                camera_matrices.position,
            )
        miss_color = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)
        img = jnp.where(miss[:, None], miss_color[None, :], img)
        # mean over the *global* pixel count: sum local, divide by global
        return jnp.sum((img - target_rows) ** 2)

    n_pixels = height * width * 4

    def shard_fn(scene, camera_matrices, ndc, target_rows):
        local_sq, grads = jax.value_and_grad(per_shard_loss)(
            scene, camera_matrices, ndc, target_rows
        )
        loss = jax.lax.psum(local_sq, axes) / n_pixels
        if not split_psum:
            grads = jax.tree_util.tree_map(
                lambda gr: jax.lax.psum(gr, axes) / n_pixels, grads
            )
            return loss, grads
        # split lever (see make_train_step docstring): small grads reduce
        # in their own all-reduce, and the volume all-reduce is made
        # data-dependent on its RESULT so the all-reduce combiner cannot
        # re-merge them.  The dependency is real arithmetic, not an
        # optimization_barrier: XLA's barrier expander can run before the
        # combiner (observed on the CPU pipeline), dissolving a
        # barrier-only ordering.  ``s - s`` is exactly +0.0 for finite s
        # and floats are not x-x-foldable (NaN/Inf), so the add survives
        # optimization, fuses into the scatter epilogue, and leaves the
        # gradients bit-identical (loss grads are finite by construction).
        small = jax.tree_util.tree_map(
            lambda gr: jax.lax.psum(gr, axes) / n_pixels,
            (grads.importance, grads.tf_lut),
        )
        s = sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(small))
        # nan_to_num: exactly +0.0 even if a small-grad entry is inf/NaN
        # (plain s - s would poison the whole volume gradient then), while
        # remaining a REAL data dependency XLA cannot fold away
        zero = jnp.nan_to_num(s - s, nan=0.0, posinf=0.0, neginf=0.0)
        d_vol = jax.lax.psum(grads.volume + zero, axes) / n_pixels
        grads = Scene(volume=d_vol, importance=small[0], tf_lut=small[1])
        return loss, grads

    @jax.jit
    def step(scene, camera_matrices, target):
        ndc = rays_mod.pixel_ndc(height, width)
        target_rows = target.reshape(-1, 4)
        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(), spec_r, spec_r),
            out_specs=(P(), P()),
            check_vma=False,
        )(scene, camera_matrices, ndc, target_rows)

    return step
