"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices (sharding tests
build meshes over them) unless JAX_PLATFORMS says otherwise.  Tests that
need a GPU carry the ``gpu`` marker and take the ``gpu`` fixture, which
skips them when the first device is not a GPU; on a GPU machine run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skipped elsewhere; see the gpu fixture)"
    )


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


@pytest.fixture
def eight_devices():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh)")
