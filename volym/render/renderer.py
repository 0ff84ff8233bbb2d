"""Top-level renderer factory — the "demo" layer.

The analog of the reference's ``ComputeDemo`` trait + ``BaseDemo`` plumbing
(``src/demos/mod.rs:9-17``, ``src/demos/pipeline.rs:113-226``): wire a scene
(bind groups -> pytree) and parameters (uniforms -> static config) into a
callable that renders frames for successive cameras.  "Updating GPU state"
per frame is just calling the jitted function with new camera matrices.

Backend choice lives here and only here (:func:`render_fn`): the CLI, the
viewer, :func:`make_renderer` and the sharded entries of
:mod:`volym.parallel.mesh` all take a backend name and resolve it through
:func:`check_backend`.  What a backend computes never depends on the device
it runs on.
"""

from __future__ import annotations

from typing import Callable

from volym.config import RenderParams
from volym.scene import Scene

#: ``ray``: the reference-parity t-step march (every mode, adaptive
#: stepping); ``slab``: the slab-ordered march of :mod:`volym.render.slab`,
#: plain jnp/lax left to XLA.
BACKENDS = ("ray", "slab")


def check_backend(backend: str) -> str:
    """Return ``backend`` if it names a renderer, else raise ValueError."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown renderer backend {backend!r}; choose one of {BACKENDS}"
        )
    return backend


def render_fn(backend: str, differentiable: bool = False) -> Callable:
    """Single-device ``(scene, camera_matrices, params, height, width) ->
    (H, W, 4)`` for a backend; ``differentiable`` picks the fixed-step
    replay-VJP march."""
    if check_backend(backend) == "slab":
        from volym.render import slab

        return slab.render_diff if differentiable else slab.render
    if differentiable:
        from volym.render import diff

        return diff.render
    from volym.render import fast

    return fast.render


def make_renderer(
    scene: Scene,
    params: RenderParams,
    height: int,
    width: int,
    mesh=None,
    differentiable: bool = False,
    backend: str = "ray",
) -> Callable:
    """Returns ``render(camera_matrices) -> (H, W, 4) image``.

    ``mesh``: shard rays over a ``jax.sharding.Mesh`` (several devices);
    ``differentiable``: use the fixed-step custom-VJP march;
    ``backend``: one of :data:`BACKENDS`.
    """
    if mesh is not None:
        from volym.parallel.mesh import render_sharded

        check_backend(backend)

        def render(camera_matrices):
            return render_sharded(
                scene, camera_matrices, params, height, width, mesh,
                differentiable=differentiable, backend=backend,
            )

        return render

    march = render_fn(backend, differentiable)
    return lambda camera_matrices: march(scene, camera_matrices, params, height, width)
