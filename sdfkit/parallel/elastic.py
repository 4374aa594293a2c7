"""Restartable (fault-tolerant) rendering: SURVEY §5's failure-detection /
elastic-recovery plan — "multi-host render jobs are restartable from the
voxel/ray-tile level".

The reference has nothing here (a crashed render is simply lost); large
multi-chip frames make restartability worth having: the frame renders in row
TILES, every finished tile is persisted atomically (tmp + rename, one .npy
per tile plus a manifest), and a re-run of the same job resumes from the
surviving tiles — bit-identical to an uninterrupted run, because each tile is
rendered by exactly the same per-tile program either way. Works single-chip
or with each tile's rows sharded over a device mesh.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sdfkit.render.raymarch import RenderConfig, render_rays
from sdfkit.utils.camera import camera_rays, default_view


def _scene_fingerprint(sdf) -> str:
    """Stable hash of the SDF's tree structure and parameter values."""
    import hashlib

    h = hashlib.sha256()
    h.update(repr(jax.tree_util.tree_structure(sdf)).encode())
    for leaf in jax.tree_util.tree_leaves(sdf):
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def render_tiles_resumable(
    sdf,
    width: int,
    height: int,
    checkpoint_dir,
    tile_rows: int = 128,
    view=None,
    mesh=None,
    progress=None,
    backend: str = "auto",
    **cfg_kwargs,
):
    """Render an (H, W, 3) image in resumable row tiles.

    Every completed tile is written to ``checkpoint_dir`` before the next
    starts; rerunning after a crash (or on another host) skips finished
    tiles. Returns ``(image, stats)`` where stats counts resumed vs rendered
    tiles. Pass ``mesh`` to shard each tile's rows over a device mesh (the
    same zero-communication row decomposition as render_sharded).

    ``backend``: 'fused' renders each tile with the GPU image kernel (rays
    generated in-kernel from the tile's pixel offset — the same fast path
    as the single-device renderer), 'interpret' the same kernel in the
    Pallas interpreter, 'jnp' the XLA path, 'auto' the rule in
    render.pallas.raymarch_kernel.resolve_backend. The backend is part of the
    tile manifest: the two paths differ at the float-rounding level, so a
    resume must use the backend that produced the existing tiles.
    """
    from sdfkit.render.pallas.raymarch_kernel import resolve_backend

    cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
    view = default_view() if view is None else jnp.asarray(view, jnp.float32)
    backend = resolve_backend(backend, sdf)
    os.makedirs(checkpoint_dir, exist_ok=True)

    manifest_path = os.path.join(checkpoint_dir, "manifest.json")
    manifest = {
        "width": width,
        "height": height,
        "tile_rows": tile_rows,
        "view": np.asarray(view).tolist(),
        # Tiles are only reusable for the SAME scene and render settings:
        # fingerprint the SDF (tree structure + parameter bytes) and the
        # full RenderConfig so a resumed run with a different job is
        # rejected instead of silently mixing stale tiles into the frame.
        "scene": _scene_fingerprint(sdf),
        "config": repr(cfg),
        "backend": backend,
    }
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            existing = json.load(f)
        if existing != manifest:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir} holds tiles of a different "
                f"job (manifest mismatch); use a fresh directory"
            )
    else:
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, manifest_path)

    # A crash between np.save(tmp) and os.replace leaves an orphan tmp file;
    # sweep them on startup so they never accumulate across crashes.
    for leftover in glob.glob(os.path.join(checkpoint_dir, "*.tmp.npy")):
        with contextlib.suppress(OSError):
            os.unlink(leftover)

    render_tile = _make_tile_renderer(sdf, view, cfg, mesh, backend)

    n_tiles = -(-height // tile_rows)
    tiles = []
    resumed = rendered = 0
    for t in range(n_tiles):
        path = os.path.join(checkpoint_dir, f"tile_{t:05d}.npy")
        if os.path.exists(path):
            tiles.append(np.load(path))
            resumed += 1
        else:
            r0 = t * tile_rows
            r1 = min(height, r0 + tile_rows)
            tile = np.asarray(render_tile(r0, r1 - r0))
            tmp = path + ".tmp.npy"
            np.save(tmp, tile)
            os.replace(tmp, path)  # atomic: a crash never leaves half a tile
            tiles.append(tile)
            rendered += 1
        if progress is not None:
            progress(t + 1, n_tiles)

    image = np.concatenate(tiles, axis=0)
    return image, {"resumed": resumed, "rendered": rendered,
                   "tiles": n_tiles}


def _make_tile_renderer(sdf, view, cfg, mesh, backend):
    """Build the per-tile render callable ``render_tile(row0, n_rows)``.

    One jitted program is shared by every tile (full tiles have one shape,
    the tail tile at most one more) — building the wrapper inside the loop
    would retrace/recompile per tile. The fused path needs no ray arrays at
    all: the kernel synthesizes the tile's rays from its flat pixel offset.
    """
    if backend != "jnp":
        from sdfkit.render.pallas import raymarch_kernel as rk

        kview = rk.view_to_kernel_view(view, cfg)
        interpret = backend == "interpret"

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            axis = mesh.axis_names[0]
            n = mesh.devices.size

            @partial(jax.jit, static_argnums=(3,))
            def fused_tile(sdf, kview, pix0, n_rows):
                rows_local = -(-n_rows // n)

                def local(sdf, kview, pix0):
                    p0 = pix0 + jax.lax.axis_index(axis) * (
                        rows_local * cfg.width
                    )
                    return rk.render_rows_fused(
                        sdf, kview, p0, cfg, rows_local, interpret
                    )

                return jax.shard_map(
                    local, mesh=mesh, in_specs=(P(), P(), P()),
                    out_specs=P(axis),
                    # Required: pallas_call defeats vma tracking (see
                    # train.build_sharded_render); tile parity is pinned by
                    # tests/test_parallel.py::TestFusedSharded
                    # ::test_elastic_tiles_fused_matches_fused_whole_frame.
                    check_vma=False,
                )(sdf, kview, pix0)[:n_rows]

        else:

            @partial(jax.jit, static_argnums=(3,))
            def fused_tile(sdf, kview, pix0, n_rows):
                return rk.render_rows_fused(sdf, kview, pix0, cfg, n_rows,
                                            interpret)

        def render_tile(r0, n_rows):
            return fused_tile(sdf, kview, jnp.int32(r0 * cfg.width), n_rows)

        return render_tile

    # jnp path: rays for the full frame once; each tile slices its rows, so
    # tile boundaries never change the ray math.
    ro, rd = camera_rays(
        cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far
    )

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from sdfkit.parallel.train import _pad_rows, shard_rays

        axis = mesh.axis_names[0]
        local = lambda sdf, ro, rd: render_rays(sdf, ro, rd, cfg)
        shmapped = jax.jit(
            jax.shard_map(
                local, mesh=mesh,
                in_specs=(P(), P(axis), P(axis)),
                out_specs=P(axis),
            )
        )

        def render_tile(r0, n_rows):
            sl = lambda a: a[r0 : r0 + n_rows]
            ro_t = jax.tree_util.tree_map(sl, ro)
            rd_t = jax.tree_util.tree_map(sl, rd)
            (ro_p, orig), (rd_p, _) = (
                _pad_rows(ro_t, mesh.devices.size),
                _pad_rows(rd_t, mesh.devices.size),
            )
            ro_p, rd_p = shard_rays(mesh, ro_p, rd_p)
            return shmapped(sdf, ro_p, rd_p)[:orig]

    else:
        jitted = jax.jit(
            lambda sdf, ro_t, rd_t: render_rays(sdf, ro_t, rd_t, cfg)
        )

        def render_tile(r0, n_rows):
            sl = lambda a: a[r0 : r0 + n_rows]
            return jitted(
                sdf,
                jax.tree_util.tree_map(sl, ro),
                jax.tree_util.tree_map(sl, rd),
            )

    return render_tile
