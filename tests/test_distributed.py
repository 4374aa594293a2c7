"""The multi-process `jax.distributed` coordinator path.

Everything else in the suite runs single-process on virtual devices; this
test actually spawns two local CPU processes that rendezvous on a localhost
coordinator via ``parallel.distributed.initialize``, build the GLOBAL mesh,
and check a psum and a row-sharded render against single-process output
(tools/distributed_demo.py). Skipped where the sandbox forbids subprocesses.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _can_spawn() -> bool:
    try:
        return (
            subprocess.run(
                [sys.executable, "-c", "print('ok')"],
                capture_output=True,
                timeout=60,
            ).returncode
            == 0
        )
    except Exception:
        return False


@pytest.mark.skipif(not _can_spawn(), reason="subprocesses unavailable")
def test_two_process_coordinator_psum_and_render():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import distributed_demo

    distributed_demo.launch(num_processes=2, timeout=280.0)


@pytest.mark.skipif(not _can_spawn(), reason="subprocesses unavailable")
def test_four_process_coordinator_psum_and_render():
    """>=4 processes on one localhost coordinator: the
    same wiring a real pod-slice run uses via
    ``tools/scaling.py --coordinator`` — multi-host readiness is tested,
    only the DCN fabric is simulated by localhost."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import distributed_demo

    distributed_demo.launch(num_processes=4, timeout=280.0)
