"""Two-process `jax.distributed` exercise.

The reference is single-process (SURVEY.md §2: distributed backend ABSENT);
this framework's multi-host story is `parallel.distributed.initialize` + a
global mesh whose collectives cross hosts. Nothing in the test suite can use
real multi-host hardware, but the COORDINATOR code path is fully exercisable
locally: two CPU processes, a localhost coordinator, a global 4-device mesh.

Run as launcher (spawns the two workers, checks their output):

    python tools/distributed_demo.py

or as a worker (what the launcher spawns):

    python tools/distributed_demo.py --worker --coordinator localhost:PORT \
        --num-processes 2 --process-id K

Each worker initializes jax.distributed, builds the global mesh via
`parallel.distributed.make_mesh`, and verifies on its local shards:
  1. a psum over the global mesh (the collective every gradient all-reduce
     rides) returns the global sum on every device;
  2. a row-sharded sphere-trace depth render matches the single-process
     render of the same rays.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_DEVICES_PER_PROCESS = 2


def _worker(coordinator: str, num_processes: int, process_id: int) -> None:
    # Workers are spawned by absolute script path, so the repo root is not
    # on sys.path automatically.
    sys.path.insert(0, REPO)
    # jax.distributed.initialize must run before any backend exists, so
    # discard any already-initialized one and select the CPU.
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.extend.backend

    jax.extend.backend.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES_PER_PROCESS)

    from sdfkit.parallel import distributed

    distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    assert jax.process_count() == num_processes, jax.process_count()

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = distributed.make_mesh()
    n = mesh.devices.size
    assert n == num_processes * LOCAL_DEVICES_PER_PROCESS, n

    # --- 1. psum over the global mesh ---
    sharding = NamedSharding(mesh, P("rays"))
    x = jax.make_array_from_callback(
        (n,), sharding, lambda idx: np.arange(n, dtype=np.float32)[idx]
    )
    total = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(jnp.sum(x), "rays").reshape(1),
            mesh=mesh,
            in_specs=P("rays"),
            out_specs=P("rays"),
        )
    )(x)
    expected = n * (n - 1) / 2.0
    for s in total.addressable_shards:
        got = float(np.asarray(s.data)[0])
        assert got == expected, (got, expected)

    # --- 2. row-sharded render parity vs single-process ---
    import sdfkit as sk
    from sdfkit.render.raymarch import RenderConfig, render_depth_rays
    from sdfkit.utils.camera import camera_rays, default_view

    W, H = 16, 2 * n
    cfg = RenderConfig(width=W, height=H)
    scene = sk.sphere(1.0)
    ro, rd = camera_rays(
        W, H, default_view(), cfg.vfov_degrees, cfg.near, cfg.far
    )
    rows = H // n

    def local_render(sdf, ro, rd):
        i = jax.lax.axis_index("rays")
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * rows, rows, 0)
        return render_depth_rays(
            sdf,
            jax.tree_util.tree_map(sl, ro),
            jax.tree_util.tree_map(sl, rd),
            cfg,
        )

    depth = jax.jit(
        jax.shard_map(
            local_render,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P("rays"),
        )
    )(scene, ro, rd)
    ref = np.asarray(render_depth_rays(scene, ro, rd, cfg))
    for s in depth.addressable_shards:
        r0 = s.index[0].start or 0
        np.testing.assert_allclose(
            np.asarray(s.data), ref[r0 : r0 + rows], atol=1e-6
        )

    print(f"DISTRIBUTED_OK process={process_id}/{num_processes} "
          f"global_devices={n}", flush=True)
    jax.distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(num_processes: int = 2, timeout: float = 300.0) -> None:
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [
                sys.executable, os.path.abspath(__file__), "--worker",
                "--coordinator", coordinator,
                "--num-processes", str(num_processes),
                "--process-id", str(i),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=REPO,
        )
        for i in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "DISTRIBUTED_OK" not in out:
            raise RuntimeError(
                f"worker {i} failed (rc={p.returncode}):\n{out[-4000:]}"
            )
    print(f"jax.distributed exercise passed: {num_processes} processes x "
          f"{LOCAL_DEVICES_PER_PROCESS} devices")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=0)
    args = ap.parse_args()
    if args.worker:
        _worker(args.coordinator, args.num_processes, args.process_id)
    else:
        launch(args.num_processes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
