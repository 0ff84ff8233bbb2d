"""Multi-host runtime bootstrap and distributed training loop.

The reference is strictly single-process / single-GPU (``src/main.rs``);
multi-host execution is new capability (SURVEY.md section 2, distributed
table).  JAX needs one ``jax.distributed.initialize()`` call per process
before any device use.  On a GPU host nothing announces a cluster, so a
bare call fails: the coordinator address (any free port on process 0's
host), the process count and this process's id come from env vars:

    # host 0
    VOLYM_COORDINATOR=host0:8476 VOLYM_NUM_PROCESSES=2 VOLYM_PROCESS_ID=0 \\
        python -m volym fit --distributed --renderer slab ...
    # host 1: same command with VOLYM_PROCESS_ID=1

Every host runs the same entrypoint, :func:`maybe_initialize` wires the
runtime, the ``(host, rays)`` mesh from
:func:`volym.parallel.mesh.make_host_mesh` reduces gradients inside each
host first and across the network last, and only process 0 writes
artifacts.  One process drives every card of its host.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

#: env names, in the order (coordinator, num_processes, process_id)
ENV_COORDINATOR = "VOLYM_COORDINATOR"
ENV_NUM_PROCESSES = "VOLYM_NUM_PROCESSES"
ENV_PROCESS_ID = "VOLYM_PROCESS_ID"
ENV_FORCE = "VOLYM_DISTRIBUTED"


def init_kwargs_from_env(env=os.environ) -> dict:
    """kwargs for ``jax.distributed.initialize`` from the VOLYM_* env vars
    (empty dict = leave detection to JAX, which succeeds only where a
    cluster manager such as SLURM describes the job)."""
    kwargs = {}
    if env.get(ENV_COORDINATOR):
        kwargs["coordinator_address"] = env[ENV_COORDINATOR]
    if env.get(ENV_NUM_PROCESSES):
        kwargs["num_processes"] = int(env[ENV_NUM_PROCESSES])
    if env.get(ENV_PROCESS_ID):
        kwargs["process_id"] = int(env[ENV_PROCESS_ID])
    return kwargs


def wants_distributed(flag: bool = False, env=os.environ) -> bool:
    return bool(
        flag
        or env.get(ENV_COORDINATOR)
        or env.get(ENV_FORCE) == "1"
    )


def maybe_initialize(flag: bool = False) -> bool:
    """Env/flag-driven multi-host bootstrap; no-op when single-process.

    Returns True when ``jax.distributed.initialize`` ran.  Must be called
    before any other JAX device use (the CLI entrypoints do).  Without
    ``VOLYM_COORDINATOR`` the run stays one process over its local devices
    (a bare ``initialize`` fails on a GPU host that no cluster manager
    describes); ``VOLYM_DISTRIBUTED=1`` forces the bare call."""
    if not wants_distributed(flag):
        return False
    kwargs = init_kwargs_from_env()
    if "coordinator_address" not in kwargs and os.environ.get(ENV_FORCE) != "1":
        log.info("no %s: one process over its local devices", ENV_COORDINATOR)
        return False
    import jax

    log.info("jax.distributed.initialize(%s)", kwargs)
    jax.distributed.initialize(**kwargs)
    log.info(
        "distributed runtime up: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0


def fit_distributed(
    scene,
    camera_matrices,
    target,
    params,
    *,
    steps: int = 100,
    lr: float = 1e-2,
    mesh=None,
    backend: str = "ray",
    callback=None,
):
    """Host-mesh inverse-rendering loop: sharded train step + Adam on the
    volume and TF LUT.  Works identically on 1 process (rays mesh) and N
    processes (``(host, rays)`` mesh).  Returns (fitted scene, losses)."""
    import jax
    import optax

    from volym.parallel import mesh as pmesh
    from volym.scene import Scene

    if mesh is None:
        mesh = (
            pmesh.make_host_mesh()
            if jax.process_count() > 1
            else pmesh.make_mesh()
        )
    height, width = target.shape[:2]
    step_fn = pmesh.make_train_step(
        params, height, width, mesh, backend=backend,
        camera_matrices=camera_matrices,
    )
    opt = optax.adam(lr)
    opt_state = opt.init((scene.volume, scene.tf_lut))
    losses = []
    for i in range(steps):
        loss, grads = step_fn(scene, camera_matrices, target)
        updates, opt_state = opt.update(
            (grads.volume, grads.tf_lut), opt_state
        )
        new_vol, new_lut = optax.apply_updates(
            (scene.volume, scene.tf_lut), updates
        )
        scene = Scene(volume=new_vol, importance=scene.importance, tf_lut=new_lut)
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    return scene, losses
