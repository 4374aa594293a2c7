"""Multi-device rendering and differentiable fitting over a device mesh.

The reference's only parallelism is CPU-thread data parallelism: 2048-point
batch chunks (Sdf.cs:38-45) and image row bands (RayMarcher.cs:50-61). Here
the same 1-D domain decomposition is lifted onto a ``jax.sharding.Mesh``:
image rows (ray tiles) are sharded over the ``rays`` axis with ``shard_map``;
rendering needs no cross-device communication at all, and the gradient of
the replicated SDF parameters is all-reduced automatically by ``shard_map``'s
replicated ``P()`` in-spec during the backward pass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdfkit.render.raymarch import (
    RenderConfig,
    render_depth_rays,
    render_rays,
)
from sdfkit.utils.camera import camera_rays, default_view


def _ray_specs(mesh: Mesh):
    # V3 pytrees: shard the leading (row) axis of every component over the
    # mesh's first axis (matching shard_rays' placement).
    return P(mesh.axis_names[0])


def shard_rays(mesh: Mesh, *arrays):
    """Place (H, ...) arrays/pytrees row-sharded over the mesh's first axis."""
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return tuple(
        jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), arr)
        for arr in arrays
    )


def _pad_rows(tree, n_devices: int):
    """Edge-pad the leading axis of every leaf to a multiple of n_devices.

    The reference partitions uneven row bands without complaint
    (RayMarcher.cs:50-61); sharded arrays need equal per-device extents, so
    we pad with copies of the last row (valid rays/cells whose results are
    sliced off after the gather) and return the original extent."""
    leaves = jax.tree_util.tree_leaves(tree)
    orig = leaves[0].shape[0]
    pad = (-orig) % n_devices
    if pad == 0:
        return tree, orig
    padded = jax.tree_util.tree_map(
        lambda a: jnp.concatenate(
            [a, jnp.repeat(a[-1:], pad, axis=0)], axis=0
        ),
        tree,
    )
    return padded, orig


def build_sharded_render(mesh: Mesh, sdf, view, cfg: RenderConfig,
                         depth_only: bool = False, backend: str = "auto"):
    """The EXACT jitted sharded-render program render_sharded executes,
    returned as ``(fn, args)`` so harnesses (tools/scaling.py) can lower,
    cost-analyze and time the same computation users run — scaling numbers
    are measured through this, not a lookalike."""
    from sdfkit.render.pallas import raymarch_kernel as rk

    backend = rk.resolve_backend(backend, sdf)
    axis = mesh.axis_names[0]
    n = mesh.devices.size

    if backend != "jnp":
        # Row-band fused render: each device runs the image-level kernel on
        # its own band via a traced pixel offset (one compiled kernel for
        # all shards; raymarch_kernel.render_rows_fused).
        rows_local = -(-cfg.height // n)
        kview = rk.view_to_kernel_view(view, cfg)
        interpret = backend == "interpret"

        def local(sdf, kview):
            pix0 = jax.lax.axis_index(axis) * (rows_local * cfg.width)
            return rk.render_rows_fused(sdf, kview, pix0, cfg, rows_local,
                                        interpret, depth_only)

        shmapped = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=P(axis),
            # check_vma=False is REQUIRED here, not optional: pallas_call
            # bodies mix per-shard and replicated values that JAX's vma
            # tracking cannot unify (it raises "workaround: pass
            # check_vma=False"). The output genuinely varies via pix0;
            # parity vs the vma-checked jnp shard path is pinned by
            # tests/test_parallel.py::TestFusedSharded
            # ::test_render_close_to_fused_single_device.
            check_vma=False,
        )
        return jax.jit(shmapped), (sdf, kview)

    ro, rd = camera_rays(
        cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far
    )
    (ro, _), (rd, _) = _pad_rows(ro, n), _pad_rows(rd, n)
    ro, rd = shard_rays(mesh, ro, rd)
    rfn = render_depth_rays if depth_only else render_rays
    shmapped = jax.shard_map(
        lambda sdf, ro, rd: rfn(sdf, ro, rd, cfg),
        mesh=mesh,
        in_specs=(P(), _ray_specs(mesh), _ray_specs(mesh)),
        out_specs=_ray_specs(mesh),
    )
    return jax.jit(shmapped), (sdf, ro, rd)


def render_sharded(
    mesh: Mesh,
    sdf,
    width: int,
    height: int,
    view=None,
    depth_only: bool = False,
    backend: str = "auto",
    **cfg_kwargs,
):
    """Render with image rows sharded over the mesh (zero communication;
    the multi-chip analogue of RayMarcher.Render's row-band Parallel.For).
    ``backend``: 'fused' = the GPU image kernel per row band (the path the
    single-device fast renderer uses), 'interpret' = the same kernel in the
    Pallas interpreter, 'jnp' = XLA fori_loop path, 'auto' = the rule in
    render.pallas.raymarch_kernel.resolve_backend."""
    cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
    if view is None:
        view = default_view()
    view = jnp.asarray(view, jnp.float32)
    fn, args = build_sharded_render(mesh, sdf, view, cfg, depth_only, backend)
    return fn(*args)[:height]


@partial(jax.jit, static_argnums=(0, 4, 7))
def _train_step_impl(mesh, sdf, ro, rd, cfg, target, lr, n_real_rows):
    def loss_fn(sdf):
        local = lambda sdf, ro, rd: render_rays(sdf, ro, rd, cfg)
        img = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), _ray_specs(mesh), _ray_specs(mesh)),
            out_specs=_ray_specs(mesh),
        )(sdf, ro, rd)
        # Padded rows (duplicated last row) are masked out of the loss so
        # the mean matches the unpadded computation exactly.
        row = jnp.arange(img.shape[0])[:, None, None]
        se = jnp.where(row < n_real_rows, (img - target) ** 2, 0.0)
        return jnp.sum(se) / (n_real_rows * img.shape[1] * img.shape[2])

    loss, grads = jax.value_and_grad(loss_fn)(sdf)
    new_sdf = jax.tree_util.tree_map(lambda p, g: p - lr * g, sdf, grads)
    return new_sdf, loss


@partial(jax.jit, static_argnums=(0, 3, 6, 7))
def _train_step_impl_fused(mesh, sdf, view, cfg, target, lr, n_real_rows,
                           interpret):
    """Fused-backend train step: forward AND backward are the fused kernels
    per row band (render_rows_fused's custom VJP); the replicated sdf
    gradient is psum'd by shard_map."""
    from sdfkit.render.pallas import raymarch_kernel as rk

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    rows_local = -(-cfg.height // n)

    def loss_fn(sdf):
        kview = rk.view_to_kernel_view(view, cfg)

        def local(sdf, kview):
            pix0 = jax.lax.axis_index(axis) * (rows_local * cfg.width)
            return rk.render_rows_fused(sdf, kview, pix0, cfg, rows_local,
                                        interpret)

        img = jax.shard_map(
            local, mesh=mesh, in_specs=(P(), P()), out_specs=P(axis),
            # Required: pallas_call defeats vma tracking (see
            # build_sharded_render); grad parity vs the vma-checked jnp
            # path is pinned by tests/test_parallel.py::TestFusedSharded
            # ::test_train_step_matches_jnp_backend.
            check_vma=False,
        )(sdf, kview)
        row = jnp.arange(img.shape[0])[:, None, None]
        se = jnp.where(row < n_real_rows, (img - target) ** 2, 0.0)
        return jnp.sum(se) / (n_real_rows * img.shape[1] * img.shape[2])

    loss, grads = jax.value_and_grad(loss_fn)(sdf)
    new_sdf = jax.tree_util.tree_map(lambda p, g: p - lr * g, sdf, grads)
    return new_sdf, loss


def train_step_sharded(mesh: Mesh, sdf, target, view=None, lr: float = 1e-2,
                       backend: str = "auto", **cfg_kwargs):
    """One differentiable fitting step: render the SDF over the mesh, compare
    to the target image, SGD-update the SDF's pytree parameters. The gradient
    all-reduce over the replicated parameters is inserted by XLA from the
    shard_map replication spec.

    This is the LOW-LEVEL one-step primitive (bare SGD, no optimizer state,
    no checkpointing); the full multi-chip training loop — optax chain with
    global-norm clipping, checkpoint/resume, loss history — is
    ``sdfkit.fit(..., mesh=mesh)``."""
    height, width = target.shape[:2]
    cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
    if view is None:
        view = default_view()
    view = jnp.asarray(view, jnp.float32)
    n = mesh.devices.size

    from sdfkit.render.pallas.raymarch_kernel import resolve_backend

    backend = resolve_backend(backend, sdf)
    if backend != "jnp":
        target, _ = _pad_rows(target, n)
        (target,) = shard_rays(mesh, target)
        return _train_step_impl_fused(
            mesh, sdf, view, cfg, target, jnp.float32(lr), height,
            backend == "interpret",
        )

    ro, rd = camera_rays(width, height, view, cfg.vfov_degrees, cfg.near, cfg.far)
    (ro, _), (rd, _), (target, _) = (
        _pad_rows(ro, n),
        _pad_rows(rd, n),
        _pad_rows(target, n),
    )
    ro, rd, (target,) = (*shard_rays(mesh, ro, rd), shard_rays(mesh, target))

    return _train_step_impl(
        mesh, sdf, ro, rd, cfg, target, jnp.float32(lr), height
    )


def voxelize_sharded(mesh: Mesh, sdf, vmin, vmax, nx: int, ny: int, nz: int,
                     clip_to_bounds: bool = True):
    """Dense grid sampling with z-bricks sharded over the mesh.

    The z axis (not x) is sharded so the result COMPOSES with
    ``parallel.marching.create_mesh_sharded``, whose dense phase shards the
    same axis with ppermute halo exchange: scene -> voxelize_sharded ->
    create_mesh_sharded runs multi-chip end to end with no full-grid reshard
    between the stages (tested in tests/test_parallel.py).

    Each shard builds its own cell-center coordinates INSIDE the shard_map
    body (from its axis_index and global z offsets) instead of receiving a
    materialized point grid: XLA then fuses the iota->coordinate->SDF chain
    exactly as the single-device ops/grid._voxelize_impl does, which keeps
    the values BIT-IDENTICAL to the single-device path at any device count
    (a materialized input grid changes FMA contraction and drifts by ulps).
    Cells in the divisibility padding evaluate extrapolated coordinates and
    are sliced off."""
    from sdfkit.mesh.voxels import Voxels
    from sdfkit.ops.grid import clip_values_to_bounds
    from sdfkit.utils.v3 import V3

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    vmin = jnp.asarray(vmin, jnp.float32)
    vmax = jnp.asarray(vmax, jnp.float32)
    d = (vmax - vmin) / jnp.array([nx, ny, nz], jnp.float32)
    nzL = -(-nz // n)  # z layers per device

    def local(sdf, vmin, d):
        z0 = jax.lax.axis_index(axis) * nzL
        xs = vmin[0] + (jnp.arange(nx, dtype=jnp.float32) + 0.5) * d[0]
        ys = vmin[1] + (jnp.arange(ny, dtype=jnp.float32) + 0.5) * d[1]
        zs = vmin[2] + (
            z0.astype(jnp.float32) + jnp.arange(nzL, dtype=jnp.float32) + 0.5
        ) * d[2]
        p = V3(
            jnp.broadcast_to(xs[:, None, None], (nx, ny, nzL)),
            jnp.broadcast_to(ys[None, :, None], (nx, ny, nzL)),
            jnp.broadcast_to(zs[None, None, :], (nx, ny, nzL)),
        )
        color, dist = sdf.eval(p)
        colors = jnp.stack(
            [jnp.broadcast_to(c, dist.shape) for c in (color.x, color.y, color.z)],
            axis=-1,
        )
        return dist, colors

    zspec = P(None, None, axis)
    values, colors = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=(zspec, zspec),
        )
    )(sdf, vmin, d)
    values, colors = values[:, :, :nz], colors[:, :, :nz]
    if clip_to_bounds:
        values = clip_values_to_bounds(values, vmin, vmax)
    return Voxels(values=values, colors=colors, vmin=vmin, vmax=vmax)
