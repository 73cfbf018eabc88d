"""Test configuration: an 8-virtual-device CPU platform by default.

Sharding tests run on a virtual 8-device CPU mesh (the standard JAX
pattern), with Pallas kernels interpreted.  float64 is enabled globally —
the parity path requires it; fp32 paths request their dtype explicitly.

Setting ``JAX_PLATFORMS`` to a GPU platform (``cuda``) leaves the platform
alone, so the tests marked ``gpu`` can run on a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernel.py

Whether a card is present is decided inside a fixture, never here.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    _flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
              if "xla_force_host_platform_device_count" not in f]
    _flags.append("--xla_force_host_platform_device_count=8")
    os.environ["XLA_FLAGS"] = " ".join(_flags)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    assert jax.default_backend() == "cpu", (
        "test suite requires the CPU platform but got %r — platform forcing "
        "ran after JAX initialized a backend" % jax.default_backend())
    assert len(jax.devices()) == 8, (
        "test suite requires 8 virtual CPU devices but got %d — "
        "xla_force_host_platform_device_count was not honored"
        % len(jax.devices()))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/test_gpu_kernel.py)")

# (Reference-checkout detection lives in tests/test_parity.py, the only
# consumer.)
