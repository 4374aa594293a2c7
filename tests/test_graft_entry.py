"""The dry-run entry never swaps a device it was given for the CPU."""

import pytest

import __graft_entry__ as ge


class _Gpu:
    platform = "gpu"


def test_refuses_to_replace_another_backend(monkeypatch):
    monkeypatch.setattr(ge.jax, "devices", lambda *a: [_Gpu()])
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        ge._ensure_n_cpu_devices(4)


def test_enough_devices_is_a_no_op():
    before = ge.jax.devices()
    ge._ensure_n_cpu_devices(2)  # the test backend has 8 CPU devices
    assert ge.jax.devices() == before
