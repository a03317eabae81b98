"""Test configuration.

The suite runs on the CPU with 8 virtual devices and x64 available, so the
multi-device sharding tests run without a cluster
(``--xla_force_host_platform_device_count=8``).  When ``JAX_PLATFORMS``
names another platform (``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip
tests/test_gpu_hardware.py``), the suite is left on that platform in float32
and the ``chip`` tests run there.  The env mangling must happen before jax
initializes a backend, hence module scope here.
"""

import os

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")

if ON_CPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def gpu():
    """The GPU for a ``chip`` test; skips when JAX's default device is not
    a GPU (the CPU suite).  Session scope puts it ahead of the module-scoped
    fixtures that would otherwise compute on the CPU before the skip."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
