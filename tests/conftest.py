"""Test-session platform.

By default the suite runs on an 8-device virtual CPU mesh, so it is
hermetic and fast: the platform is switched through jax.config before the
first backend use. Set DORYLUS_TEST_GPU=1 to leave JAX on the GPU instead
(`DORYLUS_TEST_GPU=1 python -m pytest tests/ -m gpu -o addopts=""` on the
card: one process, no xdist workers). Tests that need the card take the
`gpu` fixture, which decides when the test runs — never at import time —
and skips without one.
"""

import os

import pytest

if not os.environ.get("DORYLUS_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX has {dev.platform}); run "
                    "DORYLUS_TEST_GPU=1 python -m pytest tests/ -m gpu "
                    "-o addopts='' on the card")
    return dev
