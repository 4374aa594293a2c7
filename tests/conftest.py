"""Test harness configuration.

By default the tests run on the CPU backend with 8 virtual devices, so the
sharded paths are exercised without GPUs. With JAX_PLATFORMS set to anything
other than ``cpu`` the backend is left alone, so

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

runs the tests marked ``gpu`` on the card. Those tests take the ``gpu``
fixture, which skips them when the default device is not a GPU; the check
runs inside the fixture, never at import time, so every xdist worker
collects the same tests.
"""

import os

import pytest

N_VIRTUAL_DEVICES = 8
ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")

if ON_CPU:
    # Also for any subprocesses tests may spawn.
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402


def _force_cpu_devices() -> None:
    # Public teardown API (jax.extend.backend.clear_backends discards any
    # already-initialized clients and their memoized lookup); the config
    # updates then steer the re-initialization to n virtual CPU devices.
    import jax.extend.backend

    jax.extend.backend.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", N_VIRTUAL_DEVICES)


if ON_CPU:
    _force_cpu_devices()
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) == N_VIRTUAL_DEVICES, jax.devices()


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda ... -m gpu)")
    return jax.devices()[0]
