"""Benchmark harness — the analogue of the reference Perf console
(reference: Perf/Program.cs): the SphereRepeat scene (Union of RepeatXY
spheres and RepeatXZ boxes with per-cell color, Program.cs:5-41) with 40
depth iterations, plus the voxel, mesh and ICP workloads.

    python bench.py            # every workload, one JSON line
    python bench.py --sweep    # fused-kernel block / warp sweep at 1080p

Every time is the median wall clock of calls that end in
``jax.block_until_ready``, after warm-up. The result names the device
(platform, device_kind, count); the harness refuses to run without a GPU.
"""

import argparse
import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from sdfkit.utils.v3 import V3

EYE = (-2.0, 2.0, 4.0)
REPS = 7


def sphere_repeat_scene() -> sk.SdfExpr:
    """The Perf scene (Perf/Program.cs:5-22): Union of
    RepeatXY spheres and RepeatXZ boxes, per-cell color 0.9 - |i|/6."""
    r = 0.5

    def cell_color(i, p, c, d):
        return V3(
            0.9 - jnp.abs(i.x) / 6.0,
            0.9 - jnp.abs(i.y) / 6.0,
            0.9 - jnp.abs(i.z) / 6.0,
        )

    spheres = sk.sphere(r).repeat_xy(2.25 * r, 2.25 * r, cell_color)
    boxes = sk.box(r / 2).repeat_xz(3.0 * r, 3.0 * r, cell_color)
    return spheres | boxes


def hero_view():
    return sk.look_at(EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def timed(fn, *args, reps: int = REPS) -> float:
    """Median wall-clock seconds of ``fn(*args)`` after two warm-up calls."""
    for _ in range(2):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def image_loss(width, height, backend, **kw):
    """Image-sum loss through the public renderer (for jax.grad)."""

    def loss(sdf, view):
        m = sk.RayMarcher(width, height, sdf, view=view, backend=backend,
                          **kw)
        return jnp.sum(m.render())

    return loss


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def bench_render(width, height, backends=("fused", "jnp"),
                 reps: int = REPS) -> dict:
    """Forward (render) and forward+backward (jax.grad of an image-sum loss
    w.r.t. the scene and view) per backend, in one process: median ms,
    compile seconds and the memory analysis of each program."""
    scene, view = sphere_repeat_scene(), hero_view()
    out = {"size": [width, height], "reps": reps}
    for backend in backends:
        fwd = jax.jit(lambda s, v, b=backend: sk.RayMarcher(
            width, height, s, view=v, backend=b).render())
        grad = jax.jit(jax.grad(image_loss(width, height, backend),
                                argnums=(0, 1)))
        for name, fn in (("fwd", fwd), ("fwd_bwd", grad)):
            t0 = time.perf_counter()
            compiled = fn.lower(scene, view).compile()
            out[f"{name}_{backend}_compile_s"] = time.perf_counter() - t0
            out[f"{name}_{backend}_memory"] = _memory(compiled)
            out[f"{name}_{backend}_ms"] = (
                timed(compiled, scene, view, reps=reps) * 1e3
            )
    if set(backends) >= {"fused", "jnp"}:
        for name in ("fwd", "fwd_bwd"):
            out[f"{name}_xla_over_fused"] = (
                out[f"{name}_jnp_ms"] / out[f"{name}_fused_ms"]
            )
    return out


def sweep_kernel_tiling(width=1920, height=1080,
                        configs=((128, 4), (256, 4), (256, 8), (512, 4),
                                 (512, 8), (1024, 8))) -> list:
    """Fused forward and forward+backward time per (pixels per program,
    warps per program)."""
    from sdfkit.render.pallas import raymarch_kernel as rk

    saved = rk.BLOCK, rk.NUM_WARPS
    rows = []
    try:
        for block, warps in configs:
            rk.BLOCK, rk.NUM_WARPS = block, warps
            jax.clear_caches()
            r = bench_render(width, height, backends=("fused",), reps=5)
            rows.append({"block": block, "num_warps": warps,
                         "fwd_ms": r["fwd_fused_ms"],
                         "fwd_bwd_ms": r["fwd_bwd_fused_ms"],
                         "compile_s": r["fwd_fused_compile_s"]
                         + r["fwd_bwd_fused_compile_s"]})
    finally:
        rk.BLOCK, rk.NUM_WARPS = saved
        jax.clear_caches()
    return rows


def union_tree(n: int) -> sk.SdfExpr:
    """Balanced union of n translated spheres: 7 parameter scalars each
    (radius, rgb, offset) at O(log n) tree depth — a fitted-CSG scene."""
    prims = [sk.sphere(0.4).translate(float(i % 16) - 7.5,
                                      float(i // 16) * 0.5 - 2.0, 0.0)
             for i in range(n)]
    while len(prims) > 1:
        paired = [a | b for a, b in zip(prims[::2], prims[1::2])]
        prims = paired + (prims[-1:] if len(prims) % 2 else [])
    return prims[0]


def bench_param_scaling(sizes=(146,), width=1920, height=1080) -> list:
    """Fused-kernel compile and run time against scene size (parameter
    scalars), beside XLA's plain version, forward and forward+backward."""
    rows = []
    view = sk.look_at((0.0, 0.0, 12.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    for n in sizes:
        scene = union_tree(n)
        row = {"primitives": n, "param_scalars": sum(
            int(np.size(l)) for l in jax.tree_util.tree_leaves(scene))}
        for backend in ("fused", "jnp"):
            fwd = jax.jit(lambda s, v, b=backend: sk.RayMarcher(
                width, height, s, view=v, backend=b).render())
            grad = jax.jit(jax.grad(image_loss(width, height, backend)))
            for name, fn in (("fwd", fwd), ("fwd_bwd", grad)):
                t0 = time.perf_counter()
                compiled = fn.lower(scene, view).compile()
                row[f"{name}_{backend}_compile_s"] = time.perf_counter() - t0
                row[f"{name}_{backend}_ms"] = timed(compiled, scene, view,
                                                    reps=3) * 1e3
        rows.append(row)
    return rows


def bench_voxels(n: int = 256) -> dict:
    """sk.voxelize of the hero scene at n^3 (values and colors)."""
    scene = sphere_repeat_scene()
    fn = jax.jit(lambda s: sk.voxelize(s, (-2.0,) * 3, (2.0,) * 3, n, n, n))
    return {f"voxelize_{n}_ms": timed(fn, scene) * 1e3}


def bench_mesh(n: int, seq_baseline: bool, reps: int = 3) -> dict:
    """End-to-end Voxels.to_mesh at n^3 (device classify/compact + host
    geometry + device colors), with the per-phase split of the median run;
    optionally the single-threaded C++ per-cell mesher on the same grid."""
    from sdfkit import native
    from sdfkit.mesh import marching_cubes as mc

    v = sk.voxelize(sphere_repeat_scene(), (-2.0,) * 3, (2.0,) * 3, n, n, n)
    jax.block_until_ready(v.values)
    v.to_mesh()  # warm-up: compiles
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m = v.to_mesh()
        runs.append((time.perf_counter() - t0, dict(mc.LAST_TIMINGS)))
    runs.sort(key=lambda r: r[0])
    seconds, split = runs[len(runs) // 2]
    out = {f"mesh_{n}_ms": seconds * 1e3, f"mesh_{n}_vertices":
           len(m.vertices), f"mesh_{n}_phase_ms": split}
    if seq_baseline and native.available():
        values, colors = np.asarray(v.values), np.asarray(v.colors)
        t0 = time.perf_counter()
        n_verts, _ = native.mc_sequential_baseline(values, colors, 1, 0.0)
        out[f"mesh_{n}_seq_baseline_ms"] = (time.perf_counter() - t0) * 1e3
        assert n_verts == len(m.vertices), (n_verts, len(m.vertices))
    return out


def bench_icp(n: int, reps: int = 3) -> dict:
    """IterativeClosestPoint.register_points of a seeded cloud onto a
    rigidly moved copy (brute-force NN below GRID_NN_MIN_POINTS, the grid
    NN inside the scan above)."""
    from sdfkit.registration.icp import IterativeClosestPoint

    rng = np.random.default_rng(11)
    static = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ang = 0.03
    rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                    [-np.sin(ang), np.cos(ang), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    moved = static @ rot + np.float32([0.03, -0.02, 0.01])
    icp = IterativeClosestPoint(static)
    seconds = timed(lambda: icp.register_points(moved)[0], reps=reps)
    aligned, _ = icp.register_points(moved)
    return {f"icp_{n}_ms": seconds * 1e3,
            f"icp_{n}_max_err": float(np.abs(aligned - static).max())}


def device_record() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices())}


def main(argv=None) -> int:
    from sdfkit.utils.compile_cache import use_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="time the fused kernels per block/warp setting")
    opts = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("bench: needs a GPU", file=sys.stderr)
        return 2
    use_compile_cache()
    result = {"device": device_record()}
    if opts.sweep:
        result["sweep"] = sweep_kernel_tiling()
        result["param_scaling"] = bench_param_scaling()
    else:
        result["render_1080p"] = bench_render(1920, 1080)
        result["render_4k"] = bench_render(3840, 2160)
        result.update(bench_voxels(256))
        result.update(bench_mesh(256, seq_baseline=True))
        result.update(bench_mesh(512, seq_baseline=False))
        result.update(bench_icp(10_000))
        result.update(bench_icp(100_000))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
