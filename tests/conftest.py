"""Test harness config.

Multi-chip logic is tested on a virtual 8-device CPU mesh: the env vars
must be set before jax initializes its backends, hence this module-level
setup (the same technique the reference could not use — it had to test
MPI on a real cluster; we get N devices from one process).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the ambient env may point at a GPU
os.environ.setdefault("JAX_ENABLE_X64", "1")  # conformance-grade f64 on CPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import jax
import pytest

# A plugin may have imported jax before this conftest ran, so env vars alone
# aren't reliable — set the flags directly (before any backend initializes).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures_dir():
    return FIXTURES
