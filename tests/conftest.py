"""Test fixture: force CPU with 8 virtual devices (SURVEY.md section 4 item 4
— the standard JAX fake-multinode fixture).  Must run before jax imports.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them on the CPU; whether a GPU is present is decided
in the fixture, never at import time.  They run on a GPU machine with
``VOLYM_TEST_GPU=1 python -m pytest -m gpu tests/``, which leaves JAX's
default platform alone (the CPU devices stay available beside the GPU)."""

import os

ON_GPU = os.environ.get("VOLYM_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # force: the suite is defined on CPU-8
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported by a pytest plugin before this conftest runs;
# the config update still wins as long as no backend has been initialised.
import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", "test suite must run on CPU"

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
