"""Test configuration: CPU backend with 8 virtual devices (the multi-chip
sharding testbed, mirroring SURVEY.md section 4's porting note) and 64-bit
mode so the reference's float64 tolerances are testable.

``LT_TEST_PLATFORM=gpu`` keeps JAX on the GPU instead; the tests marked
``gpu`` need it (``LT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/``)
and skip elsewhere."""

import os

import pytest

# "gpu" is spelled "cuda" for JAX_PLATFORMS: the "gpu" alias would also
# demand a ROCm backend and fail on a CUDA machine.
_platform = {"gpu": "cuda"}.get(os.environ.get("LT_TEST_PLATFORM", "cpu"), "cpu")
os.environ["JAX_PLATFORMS"] = _platform  # force: the outer env may point at a GPU
if _platform == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# The outer environment may have imported jax already with another platform
# baked in; override through the config as well.
jax.config.update("jax_platforms", _platform)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none (decided here, at
    run time, never while test modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (LT_TEST_PLATFORM=gpu on a GPU machine); JAX has {dev.platform!r}")
    return dev
