"""Smoke test of the main path on NVIDIA GPUs, through the public entry points.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

Workloads are the README's hero scene (bench.sphere_repeat_scene, camera at
(-2, 2, 4), 40 march iterations) at the sizes users of an SDF library run:
render, depth and ``jax.grad`` of an image loss at 1920x1080 and 3840x2160,
``fit`` at 1920x1080, voxelize + mesh at 256^3 and 512^3, ICP at 10k and 100k
points. Each phase compares its result with the plain reference: the jnp
path under ``jax.default_matmul_precision("highest")``, the sequential C++
mesher, brute-force nearest neighbours, the seeded ICP transform.

Every phase prints one JSON line. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`` and
is printed only if every phase passed. The script exits nonzero, without that
line, on any platform other than a GPU and on any failed phase. The phase
functions take their sizes as arguments, so the CPU tests drive them small.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from bench import (
    EYE,
    bench_render,
    hero_view,
    image_loss,
    sphere_repeat_scene,
)
from sdfkit.render.pallas import raymarch_kernel as rk

FULL_HD = (1920, 1080)
UHD = (3840, 2160)
CHECKOUT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(CHECKOUT, "tests", "goldens")


class PhaseFailed(AssertionError):
    pass


def emit(phase: str, **fields) -> dict:
    rec = {"phase": phase, **fields}
    print(json.dumps(rec), flush=True)
    return rec


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def finite(x) -> bool:
    return bool(np.all(np.isfinite(np.asarray(x))))


def reference_render(sdf, width, height, view, depth_only=False, **kw):
    """The plain reference: the jnp path with float32 matmuls at full
    precision (no TF32)."""
    with jax.default_matmul_precision("highest"):
        m = sk.RayMarcher(width, height, sdf, view=view, backend="jnp", **kw)
        return np.asarray(m.render_depth() if depth_only else m.render())


def image_agreement(img, ref) -> dict:
    """The distributional contract of tests/test_goldens.py: a 40-step march
    is chaotic on silhouette-grazing rays, so two correct programs differ
    by O(1) on a few pixels; almost all must match tightly."""
    d = np.abs(np.clip(img, 0.0, 1.0) - np.clip(ref, 0.0, 1.0))
    per_px = d.max(axis=-1)
    stats = {
        "median_abs_diff": float(np.median(d)),
        "frac_px_over_1e-2": float((per_px > 1e-2).mean()),
        "frac_px_over_5e-2": float((per_px > 5e-2).mean()),
    }
    stats["ok"] = (
        stats["median_abs_diff"] <= 5e-3
        and stats["frac_px_over_1e-2"] <= 5e-3
        and stats["frac_px_over_5e-2"] <= 1e-3
    )
    return stats


# ---------------------------------------------------------------------------
# Environment.
# ---------------------------------------------------------------------------


def card_line() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi in a child
    process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def phase_env(cache_dir: str) -> dict:
    from sdfkit import native

    return emit(
        "env", jax=jax.__version__, compile_cache=cache_dir,
        native_library=native.available(),
        devices=[d.device_kind for d in jax.devices()],
    )


# ---------------------------------------------------------------------------
# Render, gradient and the fused-vs-XLA comparison.
# ---------------------------------------------------------------------------


def phase_render(width, height, compare: bool, backend="auto") -> dict:
    """sk.render and sk.render_depth on the default path; optionally the
    image against the plain reference."""
    scene, view = sphere_repeat_scene(), hero_view()
    img = np.asarray(sk.render(scene, width, height, camera_position=EYE,
                               backend=backend))
    depth = np.asarray(sk.render_depth(scene, width, height, view=view,
                                       backend=backend))
    check(img.shape == (height, width, 3) and finite(img), "render output")
    check(depth.shape == (height, width) and finite(depth), "depth output")
    rec = {"size": [width, height],
           "backend": rk.resolve_backend(backend, scene)}
    if compare:
        rec["vs_reference"] = image_agreement(
            img, reference_render(scene, width, height, view)
        )
        check(rec["vs_reference"]["ok"], "render vs reference")
    return emit("render", **rec)


def phase_depth_goldens(backend="auto") -> dict:
    """The committed 50x30 depth goldens at rtol 1e-4 (atol 1e-4 for
    near-zero entries), as tests/test_goldens.py holds the jnp path."""
    worst = 0.0
    for name, expr in (("sphere", sk.sphere(1.0)), ("box", sk.box(1.0)),
                       ("plane", sk.plane_xy())):
        golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_depth_50x30.npy"))
        depth = np.asarray(sk.render_depth(expr, 50, 30, backend=backend))
        check(np.allclose(depth, golden, rtol=1e-4, atol=1e-4),
              f"depth golden {name}")
        rel = np.abs(depth - golden) / np.maximum(np.abs(golden), 1e-4)
        worst = max(worst, float(rel.max()))
    return emit("depth_goldens", max_rel_err=worst)


def phase_grad(width, height, backend="auto") -> dict:
    """jax.grad of an image loss w.r.t. every scene parameter and the view."""
    scene, view = sphere_repeat_scene(), hero_view()
    g_sdf, g_view = jax.jit(
        jax.grad(image_loss(width, height, backend), argnums=(0, 1))
    )(scene, view)
    leaves = jax.tree_util.tree_leaves(g_sdf)
    check(all(finite(l) for l in leaves) and finite(g_view), "grad finite")
    return emit("grad", size=[width, height],
                backend=rk.resolve_backend(backend, scene),
                grad_abs_max=float(max(np.abs(l).max() for l in leaves)))


def _max_rel(ga, gb) -> float:
    """Max |a - b| over every gradient element, relative to the global
    gradient magnitude (each leaf sums ~2M cancelling per-pixel terms, so a
    leaf's own nearly-cancelled size is the wrong scale)."""
    err, scale = 0.0, 1e-6
    for a, b in zip(jax.tree_util.tree_leaves(ga),
                    jax.tree_util.tree_leaves(gb)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = max(err, float(np.max(np.abs(a - b))))
        scale = max(scale, float(np.max(np.abs(b))))
    return err / scale


def phase_grad_parity(width, height, iterations, bound,
                      backend="auto") -> dict:
    """The default path's gradient against the plain reference, judged
    against the reference's own noise floor: the same jnp gradient summed
    over two, and over three, row bands instead of one (the larger of the
    two differences). Each parameter gradient sums millions of cancelling
    per-pixel terms, and the 1e-5 central-difference normals amplify
    last-bit differences in the surface point, so any two correct programs
    differ; the path passes within ``bound`` x floor."""
    from sdfkit.render.raymarch import RenderConfig, render_rays
    from sdfkit.utils.camera import camera_rays

    scene, view = sphere_repeat_scene(), hero_view()
    cfg = RenderConfig(width=width, height=height,
                       depth_iterations=iterations)

    def loss_ref(s, v, bands=1):
        ro, rd = camera_rays(width, height, v, cfg.vfov_degrees, cfg.near,
                             cfg.far)
        cuts = [height * k // bands for k in range(bands + 1)]
        part = lambda t, a, b: jax.tree_util.tree_map(lambda x: x[a:b], t)
        return sum(
            jnp.sum(render_rays(s, part(ro, a, b), part(rd, a, b), cfg))
            for a, b in zip(cuts[:-1], cuts[1:])
        )

    grad = lambda f: jax.jit(jax.grad(f, argnums=(0, 1)))(scene, view)
    with jax.default_matmul_precision("highest"):
        g_ref = grad(loss_ref)
        floor = max(
            _max_rel(grad(lambda s, v, n=n: loss_ref(s, v, n)), g_ref)
            for n in (2, 3)
        )
    g_path = grad(image_loss(width, height, backend,
                             depth_iterations=iterations))
    err = _max_rel(g_path, g_ref)
    floor = max(floor, 1e-6)
    check(err <= bound * floor,
          f"grad parity at {iterations} iterations: {err} vs floor {floor}")
    return emit("grad_parity", size=[width, height], iterations=iterations,
                backend=rk.resolve_backend(backend, scene), max_rel_err=err,
                noise_floor=floor, bound=bound)


def phase_kernel_vs_xla(width, height) -> dict:
    """bench.bench_render: fused kernels against XLA's plain version,
    forward and forward+backward, in this process."""
    return emit("kernel_vs_xla", **bench_render(width, height))


# ---------------------------------------------------------------------------
# Fit, mesh, ICP.
# ---------------------------------------------------------------------------


def _fit_start(scene):
    """The scene with its first leaf (the sphere radius) 10 % too large."""
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    return jax.tree_util.tree_unflatten(treedef, [leaves[0] * 1.1]
                                        + leaves[1:])


def phase_fit(width, height, steps=3, backend="auto") -> dict:
    """sk.fit from the hero scene with its sphere radius 10 % too large,
    towards the hero scene's own render; the first loss against the plain
    reference's loss of the same start. (The repeat sizes make this loss
    chaotic, so a few Adam steps need not descend: only finiteness and the
    first loss are checked.)"""
    scene, view = sphere_repeat_scene(), hero_view()
    target = np.asarray(sk.render(scene, width, height, view=view,
                                  backend=backend))
    start = _fit_start(scene)
    res = sk.fit(start, target, steps=steps, view=view, backend=backend)
    ref_loss = float(np.mean(
        (reference_render(start, width, height, view) - target) ** 2
    ))
    rel = abs(res.losses[0] - ref_loss) / ref_loss
    check(all(np.isfinite(res.losses)), "fit losses finite")
    check(all(finite(l) for l in jax.tree_util.tree_leaves(res.sdf)),
          "fit params finite")
    # Silhouette pixels flip between two correct renderers (see
    # image_agreement), and those pixels dominate a squared-error loss.
    check(rel <= 5e-2, f"fit first loss vs reference: rel {rel}")
    return emit("fit", size=[width, height], steps=steps, losses=res.losses,
                reference_first_loss=ref_loss, first_loss_rel_err=rel,
                backend=rk.resolve_backend(backend, scene))


def phase_mesh(n: int, compare: bool) -> dict:
    """sk.voxelize + Voxels.to_mesh of the hero scene at n^3; optionally the
    vertex and triangle counts against the sequential C++ mesher."""
    from sdfkit import native

    v = sk.voxelize(sphere_repeat_scene(), (-2.0,) * 3, (2.0,) * 3, n, n, n)
    jax.block_until_ready(v.values)
    t0 = time.perf_counter()
    m = v.to_mesh()
    seconds = time.perf_counter() - t0
    check(len(m.vertices) > 0 and finite(m.vertices) and finite(m.normals),
          "mesh output")
    check(int(m.triangles.max()) < len(m.vertices), "mesh indices")
    rec = {"n": n, "vertices": len(m.vertices),
           "triangles": len(m.triangles) // 3,
           "first_to_mesh_s": seconds}
    if compare:
        check(native.available(), "native library for the baseline")
        n_verts, stream = native.mc_sequential_baseline(
            np.asarray(v.values), np.asarray(v.colors), 1, 0.0
        )
        rec["baseline_vertices"], rec["baseline_triangles"] = (
            n_verts, stream // 3
        )
        check(n_verts == len(m.vertices) and stream == len(m.triangles),
              "mesh counts vs sequential baseline")
    return emit("mesh", **rec)


def _seeded_clouds(n: int, seed: int):
    """A seeded cloud and a rigidly moved copy (rotation about z + shift)."""
    rng = np.random.default_rng(seed)
    static = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ang = 0.03
    rot = np.array([[np.cos(ang), np.sin(ang), 0.0],
                    [-np.sin(ang), np.cos(ang), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    return static, static @ rot + np.float32([0.03, -0.02, 0.01])


def phase_icp(n: int, nn_check_queries: int = 0) -> dict:
    """IterativeClosestPoint.register_points back onto the seeded transform;
    optionally the device NN index against brute force on a query subset."""
    from sdfkit.registration.icp import (
        GridNN,
        IterativeClosestPoint,
        nearest_neighbors,
    )

    static, moved = _seeded_clouds(n, seed=11)
    aligned, _ = IterativeClosestPoint(static).register_points(moved)
    err = float(np.abs(aligned - static).max())
    check(err <= 1e-3, f"ICP {n}: max alignment error {err}")
    rec = {"n": n, "max_alignment_err": err}
    if nn_check_queries:
        grid = GridNN(static)
        check(grid.ok, "grid NN index declined")
        q = moved[:nn_check_queries]
        got, _ = grid.query(q)
        want, _ = nearest_neighbors(static, q)
        mismatches = int(np.sum(np.asarray(got) != np.asarray(want)))
        check(mismatches == 0, f"grid NN vs brute force: {mismatches}")
        rec["nn_queries_checked"] = nn_check_queries
    return emit("icp", **rec)


# ---------------------------------------------------------------------------
# Four cards: the sharded paths, each against the same call on one card.
# ---------------------------------------------------------------------------


def _meshes(n_devices: int):
    from jax.sharding import Mesh

    from sdfkit.parallel.distributed import make_mesh

    return (make_mesh(devices=jax.devices()[:n_devices]),
            Mesh(np.array(jax.devices()[:1]), axis_names=("rays",)))


def phase_sharded_render(n_devices, width, height, backend="auto") -> dict:
    from sdfkit.parallel.train import render_sharded

    mesh, single = _meshes(n_devices)
    scene, view = sphere_repeat_scene(), hero_view()
    img, ref = (
        np.asarray(render_sharded(m, scene, width, height, view=view,
                                  backend=backend))
        for m in (mesh, single)
    )
    check(img.shape == (height, width, 3) and finite(img), "sharded render")
    agree = image_agreement(img, ref)
    check(agree["ok"], "sharded render vs one card")
    return emit("sharded_render", devices=n_devices, size=[width, height],
                backend=rk.resolve_backend(backend, scene), vs_one_card=agree,
                max_abs_diff=float(np.abs(img - ref).max()))


def phase_sharded_fit(n_devices, width, height, steps=3,
                      backend="auto") -> dict:
    mesh, single = _meshes(n_devices)
    scene, view = sphere_repeat_scene(), hero_view()
    target = np.asarray(sk.render(scene, width, height, view=view,
                                  backend=backend))
    start = _fit_start(scene)
    multi, one = (
        sk.fit(start, target, steps=steps, view=view, mesh=m,
               backend=backend)
        for m in (mesh, single)
    )
    check(np.allclose(multi.losses, one.losses, rtol=1e-3, atol=0.0),
          f"sharded fit losses {multi.losses} vs {one.losses}")
    return emit("sharded_fit", devices=n_devices, size=[width, height],
                losses=multi.losses, one_card_losses=one.losses)


def phase_sharded_mesh(n_devices, n) -> dict:
    from sdfkit.parallel.marching import create_mesh_sharded
    from sdfkit.parallel.train import voxelize_sharded

    mesh, _ = _meshes(n_devices)
    scene = sphere_repeat_scene()
    lo, hi = (-2.0,) * 3, (2.0,) * 3
    m_multi = create_mesh_sharded(
        mesh, voxelize_sharded(mesh, scene, lo, hi, n, n, n)
    )
    m_one = sk.voxelize(scene, lo, hi, n, n, n).to_mesh()
    for field in ("vertices", "colors", "normals", "triangles"):
        check(np.array_equal(getattr(m_multi, field), getattr(m_one, field)),
              f"sharded mesh {field} differ from one card")
    return emit("sharded_mesh", devices=n_devices, n=n,
                vertices=len(m_multi.vertices), bit_identical=True)


def phase_sharded_tiles(n_devices, width, height, tile_rows,
                        backend="auto") -> dict:
    from sdfkit.parallel.elastic import render_tiles_resumable

    mesh, _ = _meshes(n_devices)
    scene, view = sphere_repeat_scene(), hero_view()
    with tempfile.TemporaryDirectory(dir=CHECKOUT) as tmp:
        img, stats = render_tiles_resumable(
            scene, width, height, os.path.join(tmp, "multi"),
            tile_rows=tile_rows, view=view, mesh=mesh, backend=backend,
        )
        ref, _ = render_tiles_resumable(
            scene, width, height, os.path.join(tmp, "one"),
            tile_rows=tile_rows, view=view, backend=backend,
        )
    check(img.shape == (height, width, 3) and finite(img), "tiles output")
    agree = image_agreement(img, ref)
    check(agree["ok"], "sharded tiles vs one card")
    return emit("sharded_tiles", devices=n_devices, size=[width, height],
                tiles=stats["tiles"], vs_one_card=agree)


# ---------------------------------------------------------------------------


def run_one_card() -> None:
    phase_render(192, 108, compare=True)
    phase_depth_goldens()
    for w, h in (FULL_HD, UHD):
        phase_render(w, h, compare=(w, h) == FULL_HD)
        phase_grad(w, h)
    phase_grad_parity(*FULL_HD, iterations=8, bound=2.0)
    phase_grad_parity(*FULL_HD, iterations=40, bound=2.5)
    for w, h in (FULL_HD, UHD):
        phase_kernel_vs_xla(w, h)
    phase_fit(*FULL_HD)
    phase_mesh(256, compare=True)
    phase_mesh(512, compare=False)
    phase_icp(10_000)
    phase_icp(100_000, nn_check_queries=10_000)


def run_four_cards() -> None:
    phase_sharded_render(4, *UHD)
    phase_sharded_fit(4, *FULL_HD)
    phase_sharded_mesh(4, 512)
    phase_sharded_tiles(4, *FULL_HD, tile_rows=270)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    opts = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < opts.chips:
        print(f"chip_smoke: needs {opts.chips} GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    from sdfkit.utils.compile_cache import use_compile_cache

    emit("card", nvidia_smi=card_line())
    phase_env(use_compile_cache())
    t0 = time.perf_counter()
    if opts.chips == 4:
        run_four_cards()
    else:
        run_one_card()
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
