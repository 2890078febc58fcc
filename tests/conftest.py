"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding correctness is validated on host CPU devices (same XLA
partitioner, same collectives).  Set AVL_CHIP_TESTS=1 to leave JAX on
its default platform instead, so that the `chip`-marked tests run on
the GPU (README: "Tests").
"""

import os
import sys

import pytest

if not os.environ.get("AVL_CHIP_TESTS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX finds none (decided
    here, at run time, never while a module is imported)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform: {dev.platform}); "
                    "run with AVL_CHIP_TESTS=1 on the chip")
    return dev
