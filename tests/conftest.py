"""Test configuration: CPU backend, 8 virtual devices, f64 enabled.

Multi-device sharding logic is tested on a virtual CPU mesh
(xla_force_host_platform_device_count); numerical parity tests need f64
(the reference is all-double). Tests marked `gpu` need the card: they
take the `gpu_device` fixture, which skips them on the CPU. Run them on
a machine with a GPU with ADMM_TEST_PLATFORM=gpu python -m pytest -m gpu.
"""

import os

import pytest

ON_GPU = os.environ.get("ADMM_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# A pytest plugin may import jax before this conftest reads the
# environment; the config update applies either way.
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The GPU the test runs on; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: ADMM_TEST_PLATFORM=gpu python -m pytest -m gpu")
    return dev
