"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so multi-chip sharding
paths (shard_map over a Mesh) are exercised without accelerator hardware.  Must be
set before jax is imported anywhere.
"""

import os

# force CPU: set both the env var and the config before any backend is
# initialized, so a backend registered by a site configuration cannot win
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def fixtures_dir():
    import pathlib

    d = pathlib.Path("/root/reference/fixtures")
    if not d.exists():
        pytest.skip("reference fixtures not available")
    return d


def load_f32_raw(path) -> np.ndarray:
    return np.fromfile(path, dtype="<f4")
