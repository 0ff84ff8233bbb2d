"""Subprocess worker for the 2-process distributed-launch test.

Run as ``python tests/_dist_worker.py <out.json>`` with the VOLYM_*
distributed env vars set (tests/test_distributed_launch.py spawns two of
these).  Exercises the REAL multi-process code paths that single-process
tests cannot: ``launch.maybe_initialize`` -> ``jax.distributed.initialize``
(gloo collectives on CPU), the ``make_host_mesh`` process-boundary device
layout, and ``fit_distributed`` on a mesh spanning two OS processes.
"""

import json
import os
import sys


def main() -> None:
    out_path = sys.argv[1]
    # python puts the SCRIPT's dir (tests/) on sys.path, not the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    # pin the CPU before backend init, whatever the env says (same as
    # tests/conftest.py)
    jax.config.update("jax_platforms", "cpu")

    from volym.parallel import launch

    assert launch.wants_distributed(), "worker needs the VOLYM_* env vars"
    assert launch.maybe_initialize(), "maybe_initialize must run initialize"
    want_procs = int(os.environ[launch.ENV_NUM_PROCESSES])
    assert jax.process_count() == want_procs, (
        jax.process_count(), want_procs,
    )

    import jax.numpy as jnp

    from volym import Camera, RenderParams, Scene
    from volym.parallel import mesh as pmesh
    from volym.render import slab

    mesh = pmesh.make_host_mesh()
    # outer axis = process boundary: each mesh row is one process's devices
    assert mesh.devices.shape == (
        jax.process_count(), jax.local_device_count(),
    )
    for row, procs in enumerate(mesh.devices):
        assert all(d.process_index == row for d in procs), mesh.devices

    scene = Scene.synthetic("sphere", side=16)
    m = Camera(aspect=1.0, distance=1.1).orbit(25.0, 10.0, 0.0).matrices()
    params = RenderParams(
        use_gaussian_smoothing=False,
        raymarching_step_size=0.1,
        max_steps=40,
        use_shading=False,
        adaptive_stepping=False,
    )
    target = jnp.asarray(slab.render(scene, m, params, 16, 16))
    init = Scene(
        volume=jnp.full_like(scene.volume, 0.2),
        importance=scene.importance,
        tf_lut=scene.tf_lut,
    )
    fitted, losses = launch.fit_distributed(
        init, m, target, params, steps=4, lr=0.05, mesh=mesh, backend="slab",
    )
    assert losses[-1] < losses[0], losses

    # every process writes its own file; the test asserts cross-process and
    # vs-single-process loss equality (is_coordinator gates artifact writes
    # in the CLI — here both reports are the test's evidence)
    payload = {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "global_devices": jax.device_count(),
        "is_coordinator": launch.is_coordinator(),
        "losses": losses,
    }
    with open(out_path, "w") as f:
        json.dump(payload, f)


if __name__ == "__main__":
    main()
