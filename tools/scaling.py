"""Scaling-efficiency harness (BASELINE config 5).

Measures how the row-sharded render scales with device count. By default it
re-executes itself on the CPU backend with virtual devices (it must select the
backend before JAX starts); ``SDFKIT_SCALING_REAL=1`` measures the real
devices instead (e.g. four GPUs).

Two complementary measurements, both honest about what a virtual mesh can show:

1. **Wall-clock throughput** (rays/s at each device count): real strong
   scaling. On real multi-chip hardware this is the BASELINE config-5 number.
   On the CPU fallback mesh, each virtual device is pinned to one intra-op
   thread, so wall-clock scaling is physically meaningful only up to the
   machine's core count; points beyond that are reported but flagged
   ``cores_exceeded``.
2. **Per-device compiled work** (XLA cost analysis of the SPMD module):
   flops/bytes per device at each N. Efficiency = flops(1) / (N * flops(N)).
   This proves the sharding does 1/N work per chip with no redundant compute
   or forward-pass collectives, independent of host-core contention.

Writes one JSON document to --out and prints it.
"""

import argparse
import json
import os
import sys
import time

# XLA_FLAGS is parsed exactly once, when the backend starts, so the CPU
# backend's flags must be in place before the interpreter starts: re-exec
# once with the right environment.
if (
    os.environ.get("SDFKIT_SCALING_CHILD") != "1"
    and os.environ.get("SDFKIT_SCALING_REAL", "") != "1"
):
    env = dict(os.environ)
    env["SDFKIT_SCALING_CHILD"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        # One intra-op thread per virtual device: otherwise a single device
        # already spreads over every host core and N-device wall-clock
        # "scaling" measures nothing.
        + " --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"
    )
    os.execve(sys.executable, [sys.executable, os.path.abspath(__file__)] + sys.argv[1:], env)


def _force_cpu_devices(n: int) -> None:
    """Discard any initialized backend and select n virtual CPU devices
    (same public teardown as tests/conftest.py; jax_num_cpu_devices is
    passed at CPU-client creation so it works after XLA_FLAGS is parsed)."""
    import jax
    import jax.extend.backend

    jax.extend.backend.clear_backends()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", n)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the JSON document to this file")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument(
        "--backend", default="auto", choices=["auto", "jnp", "fused"],
        help="render backend measured; 'auto' = the backend users get from "
        "render_sharded (the fused kernels on GPUs, jnp on the CPU mesh)",
    )
    # Multi-host readiness: on several hosts, run one process per
    # host with identical arguments — a real >=2-host scaling run is then a
    # one-liner per host, no code changes:
    #   python tools/scaling.py --coordinator HOST0:1234 \
    #       --num-processes N --process-id K
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (jax.distributed)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    opts = ap.parse_args()

    import jax

    if opts.coordinator is not None:
        from sdfkit.parallel.distributed import initialize

        initialize(
            coordinator_address=opts.coordinator,
            num_processes=opts.num_processes,
            process_id=opts.process_id,
        )
    elif os.environ.get("SDFKIT_SCALING_REAL", "") != "1":
        _force_cpu_devices(max(opts.devices))
    import jax.numpy as jnp
    from jax.sharding import Mesh

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from bench import sphere_repeat_scene
    from sdfkit.parallel.train import build_sharded_render
    from sdfkit.render.raymarch import RenderConfig
    from sdfkit.utils.camera import default_view

    n_devices = len(jax.devices())
    n_cores = os.cpu_count() or 1
    on_cpu = jax.devices()[0].platform == "cpu"
    scene = sphere_repeat_scene()
    cfg = RenderConfig(
        width=opts.width, height=opts.height, depth_iterations=opts.iters
    )
    view = jnp.asarray(default_view(), jnp.float32)

    points = []
    for n in [d for d in opts.devices if d <= n_devices]:
        mesh = Mesh(jax.devices()[:n], axis_names=("rays",))
        # The ACTUAL sharded program users run: built by the same factory
        # render_sharded calls (parallel/train.py build_sharded_render), so
        # these points measure the shipped code path, not a lookalike.
        fn, args = build_sharded_render(
            mesh, scene, view, cfg, backend=opts.backend
        )
        lowered = fn.lower(*args)
        compiled = lowered.compile()
        cost = compiled.cost_analysis()
        if isinstance(cost, list):  # older jax returns [dict]
            cost = cost[0]
        flops = float(cost.get("flops", 0.0))
        bytes_ = float(cost.get("bytes accessed", 0.0))

        img = fn(*args)
        jax.block_until_ready(img)
        times = []
        for _ in range(opts.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        secs = min(times)
        points.append(
            {
                "devices": n,
                "seconds": round(secs, 4),
                "mrays_per_s": round(opts.width * opts.height / secs / 1e6, 3),
                "per_device_flops": flops,
                "per_device_bytes": bytes_,
                "cores_exceeded": bool(on_cpu and n > n_cores),
            }
        )

    base = points[0]
    for p in points:
        n = p["devices"]
        p["walltime_efficiency_pct"] = round(
            100.0 * p["mrays_per_s"] / (n * base["mrays_per_s"]), 1
        )
        p["work_partition_efficiency_pct"] = (
            round(100.0 * base["per_device_flops"] / (n * p["per_device_flops"]), 1)
            if p["per_device_flops"]
            else None
        )

    from sdfkit.render.pallas.raymarch_kernel import resolve_backend

    result = {
        "workload": {
            "scene": "SphereRepeat (Perf/Program.cs:5-22)",
            "width": opts.width,
            "height": opts.height,
            "depth_iterations": opts.iters,
            "sharding": "image rows over 1-D 'rays' mesh (shard_map)",
            "program": "parallel.train.build_sharded_render (the shipped "
                       "render_sharded path)",
        },
        "backend": jax.devices()[0].platform,
        "render_backend": resolve_backend(opts.backend, scene),
        "host_cores": n_cores,
        "num_processes": jax.process_count(),
        "points": points,
    }
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
