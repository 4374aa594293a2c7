"""Dense voxel-grid sampling of an SDF.

Reference semantics (SdfKit/Voxels.cs): the SDF is evaluated at **cell
centers** ``min + (i + 0.5) * D`` with ``D = (max - min)/n``
(Voxels.cs:81,101-106); ``clip_to_bounds`` overwrites the 6 outer wall layers
with the positive "outside" value ``size.x / nx`` so meshes close at volume
edges (Voxels.cs:133-167).

The whole grid is evaluated as one fused XLA computation over a
``(nx, ny, nz)`` meshgrid in structure-of-arrays layout — the reference's
2048-point batch loop + Parallel.For (Voxels.cs:88-124) is XLA's problem now.
For multi-device sampling, `sdfkit.parallel` shards the grid into z-bricks
over the device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sdfkit.mesh.voxels import Voxels
from sdfkit.sdf.expr import SdfExpr
from sdfkit.utils.v3 import V3


def cell_centers(vmin, vmax, nx: int, ny: int, nz: int) -> V3:
    """Cell-center sample positions as a structure-of-arrays (nx, ny, nz) grid."""
    vmin = jnp.asarray(vmin, jnp.float32)
    vmax = jnp.asarray(vmax, jnp.float32)
    d = (vmax - vmin) / jnp.array([nx, ny, nz], jnp.float32)
    xs = vmin[0] + (jnp.arange(nx, dtype=jnp.float32) + 0.5) * d[0]
    ys = vmin[1] + (jnp.arange(ny, dtype=jnp.float32) + 0.5) * d[1]
    zs = vmin[2] + (jnp.arange(nz, dtype=jnp.float32) + 0.5) * d[2]
    return V3(
        jnp.broadcast_to(xs[:, None, None], (nx, ny, nz)),
        jnp.broadcast_to(ys[None, :, None], (nx, ny, nz)),
        jnp.broadcast_to(zs[None, None, :], (nx, ny, nz)),
    )


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _voxelize_impl(sdf, vmin, vmax, nx, ny, nz, clip_to_bounds):
    p = cell_centers(vmin, vmax, nx, ny, nz)
    color, dist = sdf.eval(p)
    values = dist
    colors = jnp.stack(
        [
            jnp.broadcast_to(color.x, dist.shape),
            jnp.broadcast_to(color.y, dist.shape),
            jnp.broadcast_to(color.z, dist.shape),
        ],
        axis=-1,
    )
    if clip_to_bounds:
        values = clip_values_to_bounds(values, vmin, vmax)
    return values, colors


def clip_values_to_bounds(values: jnp.ndarray, vmin, vmax) -> jnp.ndarray:
    """Overwrite the 6 outer wall layers with the positive outside value
    ``(max.x - min.x)/nx`` (reference: Voxels.ClipToBounds, Voxels.cs:133-167)."""
    nx = values.shape[0]
    vmin = jnp.asarray(vmin, jnp.float32)
    vmax = jnp.asarray(vmax, jnp.float32)
    outside = (vmax[0] - vmin[0]) / nx
    interior = jnp.zeros_like(values, dtype=bool)
    interior = interior.at[1:-1, 1:-1, 1:-1].set(True)
    return jnp.where(interior, values, outside)


def voxelize(
    sdf: SdfExpr,
    vmin,
    vmax,
    nx: int,
    ny: int,
    nz: int,
    clip_to_bounds: bool = True,
) -> Voxels:
    """Sample ``sdf`` on a dense grid (reference: SdfEx.ToVoxels /
    Voxels.SampleSdf, Sdf.cs:49-57, Voxels.cs:72-125)."""
    vmin = jnp.asarray(vmin, jnp.float32)
    vmax = jnp.asarray(vmax, jnp.float32)
    values, colors = _voxelize_impl(
        sdf, vmin, vmax, int(nx), int(ny), int(nz), bool(clip_to_bounds)
    )
    return Voxels(values=values, colors=colors, vmin=vmin, vmax=vmax)
