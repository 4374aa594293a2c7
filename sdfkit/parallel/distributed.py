"""Multi-host setup helpers.

The reference is single-process (SURVEY.md section 2: distributed backend
ABSENT); its thread pool becomes a device mesh. For several hosts, call
:func:`initialize` once per host process before any jax call, then build a
mesh with :func:`make_mesh`; all collectives (the psum in
``train_step_sharded``'s backward, gather on image assembly) are inserted by
XLA from the sharding specs (NCCL between GPUs).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: str | None = None, **kwargs) -> None:
    """Initialize jax.distributed for a multi-host job. No-op when the
    process already is single-host-only (no coordinator given and no cluster
    env detected) — so the same program runs unchanged on one host."""
    if coordinator_address is None and not _cluster_env_present():
        return
    jax.distributed.initialize(coordinator_address=coordinator_address, **kwargs)


def _cluster_env_present() -> bool:
    import os

    return any(
        v in os.environ
        for v in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS")
    )


def make_mesh(axis_name: str = "rays", devices=None) -> Mesh:
    """A 1-D mesh over all (global) devices — the decomposition this
    framework shards over: rays/rows for rendering, x-bricks for grids."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (axis_name,))
