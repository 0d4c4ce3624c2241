"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding paths are exercised without accelerator hardware
(the "fake the mesh, not the math" strategy from SURVEY.md §4).

The backend is pinned through jax.config before first use, so the tests
run on the CPU whatever JAX_PLATFORMS says.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the fast tier compiles dozens of
# executables whose build dominates wall time, so caching them across runs
# shortens a warm run severalfold.
from mobileraytracer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
