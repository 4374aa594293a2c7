"""Differentiable SDF fitting: optimize shape/position/color parameters so a
render matches a target image.

This is the capability the reference cannot offer (its IL-compiled SDFs are
not differentiable): every SdfExpr is a pytree of parameter leaves and the
renderer is pure jnp, so ``jax.value_and_grad`` of an image loss flows
through the 40-step march, the finite-difference normals and the shading
(BASELINE.md differentiable smooth-union CSG config). Single device by
default; ``fit(..., mesh=mesh)`` runs the identical optax loop over a device
mesh — rays and target rows sharded, the parameter-gradient all-reduce
inserted by shard_map — with checkpoint/resume intact (see
_fit_step_sharded).

Checkpoint/resume is via orbax (SURVEY.md section 5, checkpoint entry), an
optional dependency (``pip install sdfkit[checkpoint]``) imported only when
``checkpoint_dir`` is given: the optimizer state and parameters are saved
every ``checkpoint_every`` steps and ``fit`` resumes from the latest step
found in ``checkpoint_dir``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from sdfkit.render.raymarch import RenderConfig, render_rays
from sdfkit.utils.camera import camera_rays, default_view

Array = Any


@dataclasses.dataclass(frozen=True)
class FitResult:
    sdf: Any
    losses: list[float]
    steps_run: int
    resumed_from: int | None


def image_loss_fn(sdf, target, ro, rd, cfg: RenderConfig) -> Array:
    img = render_rays(sdf, ro, rd, cfg)
    return jnp.mean((img - target) ** 2)


@partial(jax.jit, static_argnums=(0, 1))
def _fit_step(optimizer, cfg, sdf, opt_state, target, ro, rd):
    loss, grads = jax.value_and_grad(image_loss_fn)(sdf, target, ro, rd, cfg)
    updates, opt_state = optimizer.update(grads, opt_state, sdf)
    sdf = optax.apply_updates(sdf, updates)
    return sdf, opt_state, loss


@partial(jax.jit, static_argnums=(0, 1, 2, 7))
def _fit_step_sharded(optimizer, cfg, mesh, sdf, opt_state, target_sh,
                      rays_sh, n_real_rows):
    """The full fit step over a device mesh: rays and target rows are sharded
    over the mesh's first axis, the SDF parameters and optimizer state are
    replicated, and the backward pass all-reduces the parameter gradients
    (inserted by XLA from shard_map's replicated P() in-spec). The
    same optax chain as the single-device step runs on the psum'd gradient —
    including the global-norm clipping that sphere-trace losses need (see
    fit()'s optimizer default) — so sharded and single-device fits walk the
    same trajectory up to reduction rounding."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    ro, rd = rays_sh

    def loss_fn(sdf):
        local = lambda sdf, ro, rd: render_rays(sdf, ro, rd, cfg)
        img = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(axis), P(axis)),
            out_specs=P(axis),
        )(sdf, ro, rd)
        # Padded rows (duplicated last row, added to make the extent divide
        # the mesh) are masked out so the mean matches the unpadded loss.
        row = jnp.arange(img.shape[0])[:, None, None]
        se = jnp.where(row < n_real_rows, (img - target_sh) ** 2, 0.0)
        return jnp.sum(se) / (n_real_rows * img.shape[1] * img.shape[2])

    loss, grads = jax.value_and_grad(loss_fn)(sdf)
    updates, opt_state = optimizer.update(grads, opt_state, sdf)
    sdf = optax.apply_updates(sdf, updates)
    return sdf, opt_state, loss


@partial(jax.jit, static_argnums=(0, 1, 2))
def _fit_step_fused(optimizer, cfg, interpret, sdf, opt_state, target, view):
    """Fit step through the fused kernels: forward = the image-level
    sphere-trace kernel, backward = the march-replay pullback kernel
    (render/pallas/raymarch_kernel.py)."""
    from sdfkit.render.pallas.raymarch_kernel import render_image_fused

    def loss_fn(sdf):
        img = render_image_fused(sdf, view, cfg, interpret)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(sdf)
    updates, opt_state = optimizer.update(grads, opt_state, sdf)
    sdf = optax.apply_updates(sdf, updates)
    return sdf, opt_state, loss


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 7))
def _fit_step_sharded_fused(optimizer, cfg, mesh, interpret, sdf, opt_state,
                            target_sh, n_real_rows, view):
    """The sharded fit step with the fused kernels as the per-band renderer:
    forward AND backward are one kernel per device row band
    (raymarch_kernel.render_rows_fused and its custom VJP); shard_map's
    replicated in-spec psums the parameter gradients, and the same optax
    chain as the single-device step runs on the reduced gradient."""
    from jax.sharding import PartitionSpec as P

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
            # train.build_sharded_render); fused mesh-fit parity is pinned
            # by tests/test_parallel.py::TestFusedSharded
            # ::test_fit_mesh_fused_runs.
            check_vma=False,
        )(sdf, kview)
        row = jnp.arange(img.shape[0])[:, None, None]
        se = jnp.where(row < n_real_rows, (img - target_sh) ** 2, 0.0)
        return jnp.sum(se) / (n_real_rows * img.shape[1] * img.shape[2])

    loss, grads = jax.value_and_grad(loss_fn)(sdf)
    updates, opt_state = optimizer.update(grads, opt_state, sdf)
    sdf = optax.apply_updates(sdf, updates)
    return sdf, opt_state, loss


def fit(
    sdf,
    target,
    steps: int = 100,
    view=None,
    optimizer=None,
    learning_rate: float = 1e-2,
    checkpoint_dir=None,
    checkpoint_every: int = 50,
    progress: Callable[[int, float], None] | None = None,
    backend: str = "auto",
    mesh=None,
    **cfg_kwargs,
) -> FitResult:
    """Fit ``sdf``'s parameters so its render matches ``target`` (H, W, 3).

    Returns a FitResult with the fitted SdfExpr and per-step losses. If
    ``checkpoint_dir`` is given, training state is checkpointed there and a
    later call with the same directory resumes from the latest saved step.

    ``backend``: 'fused' differentiates through the GPU forward+backward
    kernels, 'interpret' runs those kernels in the Pallas interpreter, 'jnp'
    uses XLA autodiff through the pure-jnp renderer, 'auto' follows
    render.pallas.raymarch_kernel.resolve_backend.

    ``mesh``: a ``jax.sharding.Mesh`` to run every step over several
    devices — image rows (rays + target) are sharded over the mesh's first
    axis, parameters and optimizer state are replicated, and the
    parameter gradients are all-reduced. The full optax chain (including the load-bearing
    global-norm clipping), checkpointing and resume behave exactly as on a
    single device. ``backend`` composes with ``mesh``: the fused path runs
    the forward+backward kernels per device row band
    (_fit_step_sharded_fused). ``parallel.train_step_sharded`` remains the
    low-level one-step primitive this loop supersedes.
    """
    target = jnp.asarray(target, jnp.float32)
    height, width = target.shape[:2]
    cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
    view = default_view() if view is None else jnp.asarray(view, jnp.float32)
    ro, rd = camera_rays(width, height, view, cfg.vfov_degrees, cfg.near, cfg.far)

    target_sh = rays_sh = None
    if mesh is not None:
        from sdfkit.parallel.train import _pad_rows, shard_rays

        n = mesh.devices.size
        (ro_p, _), (rd_p, _), (target_p, _) = (
            _pad_rows(ro, n),
            _pad_rows(rd, n),
            _pad_rows(target, n),
        )
        ro_p, rd_p, (target_sh,) = (
            *shard_rays(mesh, ro_p, rd_p),
            shard_rays(mesh, target_p),
        )
        rays_sh = (ro_p, rd_p)

    if optimizer is None:
        # Sphere-trace image losses have heavy-tailed gradients: a ray that
        # grazes a silhouette accumulates depth ~far^k and its parameter
        # gradient explodes, so unclipped Adam overshoots (radius blows up
        # until the shape fills the frame). Global-norm clipping tames the
        # tail without biasing the well-behaved interior-pixel gradients.
        optimizer = optax.chain(
            optax.clip_by_global_norm(1.0), optax.adam(learning_rate)
        )
    opt_state = optimizer.init(sdf)

    start_step, resumed_from = 0, None
    manager = None
    if checkpoint_dir is not None:
        manager = _checkpoint_manager(checkpoint_dir)
        latest = manager.latest_step()
        if latest is not None:
            sdf, opt_state = _restore(manager, latest, (sdf, opt_state))
            if mesh is not None:
                # Restored leaves come back committed to the default device;
                # re-replicate them so they compose with the sharded rays.
                from jax.sharding import NamedSharding, PartitionSpec

                rep = NamedSharding(mesh, PartitionSpec())
                sdf, opt_state = jax.tree_util.tree_map(
                    lambda a: jax.device_put(a, rep), (sdf, opt_state)
                )
            start_step, resumed_from = latest, latest

    from sdfkit.render.pallas.raymarch_kernel import resolve_backend

    backend = resolve_backend(backend, sdf)
    interpret = backend == "interpret"
    losses: list[float] = []
    for step in range(start_step, steps):
        if mesh is not None and backend != "jnp":
            sdf, opt_state, loss = _fit_step_sharded_fused(
                optimizer, cfg, mesh, interpret, sdf, opt_state, target_sh,
                height, view,
            )
        elif mesh is not None:
            sdf, opt_state, loss = _fit_step_sharded(
                optimizer, cfg, mesh, sdf, opt_state, target_sh, rays_sh,
                height,
            )
        elif backend != "jnp":
            sdf, opt_state, loss = _fit_step_fused(
                optimizer, cfg, interpret, sdf, opt_state, target, view
            )
        else:
            sdf, opt_state, loss = _fit_step(
                optimizer, cfg, sdf, opt_state, target, ro, rd
            )
        loss = float(loss)
        losses.append(loss)
        if progress is not None:
            progress(step, loss)
        if manager is not None and (
            (step + 1) % checkpoint_every == 0 or step + 1 == steps
        ):
            _save(manager, step + 1, (sdf, opt_state))
    if manager is not None:
        manager.wait_until_finished()
    return FitResult(
        sdf=sdf, losses=losses, steps_run=steps - start_step, resumed_from=resumed_from
    )


# -- orbax plumbing ----------------------------------------------------------


def _checkpoint_manager(path):
    import os

    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        os.path.abspath(os.fspath(path)),
        options=ocp.CheckpointManagerOptions(max_to_keep=2, create=True),
    )


def _save(manager, step: int, state) -> None:
    import orbax.checkpoint as ocp

    manager.save(step, args=ocp.args.StandardSave(_to_pure(state)))


def _restore(manager, step: int, like):
    import orbax.checkpoint as ocp

    pure = manager.restore(
        step, args=ocp.args.StandardRestore(_to_pure(like))
    )
    leaves = jax.tree_util.tree_leaves(pure)
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _to_pure(tree):
    """Orbax serializes plain array pytrees; SdfExpr nodes carry static
    callables in their treedef, so ship leaves as a flat list and rebuild
    with the caller's treedef on restore."""
    return jax.tree_util.tree_leaves(tree)
