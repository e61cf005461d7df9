"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding tests use shard_map over these virtual devices.
Tests marked `gpu` need a card: they skip unless JAX_PLATFORMS names
cuda (JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests). Speed is
measured on the card by chip_smoke.py and the bench scripts, not here.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

_platforms = os.environ.get("JAX_PLATFORMS", "")
jax.config.update(
    "jax_platforms", _platforms if "cuda" in _platforms else "cpu"
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (covered on the card by "
                    "chip_smoke.py)")
    return jax.devices()[0]
