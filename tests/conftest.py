"""Test harness configuration.

Unless JAX_PLATFORMS names another platform, the suite runs on the CPU
backend with 8 virtual XLA host devices, so the shard_map drivers run over
a host mesh and every code path is exercised without a GPU. Tests that need
the card carry the ``gpu`` marker and take the ``gpu`` fixture, which skips
them when JAX finds no GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

from tileqr.utils.cache import configure_compile_cache  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    # float64 oracles alongside the float32 paths
    jax.config.update("jax_enable_x64", True)
# The suite's compile cost is a long tail of sub-second compiles, so every
# program is cached (threshold 0).
configure_compile_cache(min_compile_secs=0.0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided here,
    at run time, never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run without JAX_PLATFORMS=cpu on the card)")
    return jax.devices()[0]


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU backend (skips elsewhere)")
    config.addinivalue_line("markers", "slow: long-running acceptance config")
