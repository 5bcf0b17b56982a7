"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the reference's config-sweep strategy (ci/blackbox.sh topology flags,
ci/regression.sh.in graphics() --clusters=2 --cores=2): multi-device
topologies are simulated with XLA's host-platform device partitioning so
sharding tests run without accelerators.  Pallas kernels run in interpret
mode only where a test asks for it.

Tests marked `gpu` need a CUDA device: the `gpu_device` fixture skips them
elsewhere (the check runs inside the fixture, never at import).  Run them
on a GPU machine with

    SKYBOX_TEST_PLATFORM=cuda python -m pytest -m gpu tests/test_gpu.py
"""
import os

import pytest

platform = os.environ.get("SKYBOX_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if platform == "cpu" and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", platform)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev
