"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding/multi-device paths are validated on host CPU with
``--xla_force_host_platform_device_count=8``. Unless ``JAX_PLATFORMS``
names a platform, the tests are held to the CPU. The ``gpu``-marked tests
need the card: run them with ``JAX_PLATFORMS=cuda python -m pytest tests/
-m gpu -p no:xdist`` (one process, since every JAX process reserves most of
the card's memory); elsewhere the ``gpu`` fixture skips them.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default platform is {platform!r}")
