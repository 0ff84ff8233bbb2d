"""2-process distributed launch test (VERDICT r4 item 3).

Actually EXECUTES the multi-process runtime path that every other test
only plumbs single-process: two OS processes bootstrap through
``launch.maybe_initialize`` (env-driven ``jax.distributed.initialize``
with gloo CPU collectives), build the ``(host, rays)`` mesh across the
process boundary, and run ``fit_distributed`` — asserting both processes
observe identical losses, equal (mod reduction order) to a
single-process run of the same fit.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_fit_matches_single(tmp_path):
    port = _free_port()
    from volym.parallel import launch

    procs, outs = [], []
    for pid in range(2):
        out = tmp_path / f"proc{pid}.json"
        outs.append(out)
        env = dict(os.environ)
        env.update(
            {
                launch.ENV_COORDINATOR: f"localhost:{port}",
                launch.ENV_NUM_PROCESSES: "2",
                launch.ENV_PROCESS_ID: str(pid),
                # 2 virtual CPU devices per process -> 4 global devices
                "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
                "JAX_PLATFORMS": "cpu",
            }
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER, str(out)],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    payloads = [json.loads(out.read_text()) for out in outs]
    payloads.sort(key=lambda d: d["process_index"])
    assert [d["process_index"] for d in payloads] == [0, 1]
    assert all(d["process_count"] == 2 for d in payloads)
    assert all(d["global_devices"] == 4 for d in payloads)
    assert [d["is_coordinator"] for d in payloads] == [True, False]
    # the loss is a psum'd global scalar: both processes must agree exactly
    np.testing.assert_array_equal(payloads[0]["losses"], payloads[1]["losses"])

    # single-process reference: same fit on this process's virtual mesh
    # (8 devices via conftest).  Identical math up to psum reduction order.
    import jax.numpy as jnp

    from volym import Camera, RenderParams, Scene
    from volym.render import slab

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
    _, ref_losses = launch.fit_distributed(
        init, m, target, params, steps=4, lr=0.05, backend="slab",
    )
    np.testing.assert_allclose(
        payloads[0]["losses"], ref_losses, rtol=1e-5, atol=1e-7
    )
