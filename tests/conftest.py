"""Test configuration: an 8-device virtual CPU mesh by default.

Sharding behavior is validated on a virtual CPU mesh exactly as the
driver's dryrun does. The suite runs on the CPU unless ``JAX_PLATFORMS``
names another backend; tests marked ``gpu`` need the card and skip
elsewhere (decided per test in the fixture below, never at import).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if request.node.get_closest_marker("gpu") is not None and (
        jax.default_backend() != "gpu"
    ):
        pytest.skip("needs a GPU: run `JAX_PLATFORMS=cuda pytest -m gpu`")
