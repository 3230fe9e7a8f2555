"""Test harness: run on the CPU with 8 virtual devices, so the multi-device
sharding code (shard_map + halo exchange) is exercised without a GPU.

Tests marked ``gpu`` need the card.  They take the ``gpu_device`` fixture,
which skips them here; ``python chip_smoke.py`` runs what they check on
the GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (the suite runs on the CPU; "
                    "chip_smoke.py covers this on the card)")
    return dev
