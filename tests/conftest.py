"""Test harness config: run JAX on a virtual 8-device CPU mesh so the
sharding paths run without cards.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``python chip_smoke.py``
runs them on the card (``pytest -m gpu``)."""

import os

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
# keep the suite hermetic: never read/write the user-level routing cache
# (tests that exercise persistence opt in with a tmp_path override)
os.environ.setdefault("TPUDRACO_ROUTE_CACHE", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

from tpudraco.utils.compile_cache import enable_compile_cache  # noqa: E402

# the suite is compile-heavy (x64 UV chain, shard_map oracles); warm
# runs skip all of it
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py on the card)")
    return devs[0]
