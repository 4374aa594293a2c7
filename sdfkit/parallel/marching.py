"""Multi-device marching cubes: the dense O(n^3) phase sharded over a device
mesh as z-bricks with step-layer halo exchange.

SURVEY §5 maps the reference's only cross-partition dependency — marching-
cubes cell adjacency, which the reference handles by running meshing strictly
sequentially (MarchingCubes.cs:53-80) — to "voxel bricks sharded with 1-cell
halos" on a device mesh. That is what this module does: the value/color grids
are sharded along z, each device classifies and compacts the cells of its own
brick, and the one-cell (``step``-layer) corner overlap at each brick seam is
satisfied by a single ``jax.lax.ppermute`` that passes each brick's first
``step`` z-layers to the previous device — one collective, no gather of
the full grid anywhere.

The per-device dense work is the same classify/compact/corner-gather the
single-device path runs per z-slab (mesh/marching_cubes.py); the host sparse
phase is shared verbatim. Because devices own disjoint, ascending z ranges
and cells stay in (z, y, x) order within a brick, concatenating the
per-device active lists reproduces the single-device cell stream exactly —
the resulting mesh is BIT-IDENTICAL for any device count (tested on the
8-virtual-device CPU mesh in tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sdfkit.mesh import luts
from sdfkit.mesh.marching_cubes import _sparse_phase
from sdfkit.mesh.mesh import Mesh as TriMesh


def _classify_brick(ext, iso, d0_cells, step: int, lx: int, ly: int,
                    m: int, lz: int):
    """Case bytes + active mask for the ``m`` cell layers of one z-brick.

    ``ext`` is the brick plus its ``step``-layer halo, (nx, ny, m*step+step).
    ``d0_cells`` is this device's first global cell-layer index; cell layers
    at or beyond ``lz`` are padding and masked off.
    """
    bits = jnp.zeros((lx, ly, m), jnp.uint8)
    for k in range(8):
        dx = int(luts.CORNER_DX[k]) * step
        dy = int(luts.CORNER_DY[k]) * step
        dz = int(luts.CORNER_DZ[k]) * step
        corner = jax.lax.slice(
            ext,
            (dx, dy, dz),
            (dx + (lx - 1) * step + 1, dy + (ly - 1) * step + 1,
             dz + (m - 1) * step + 1),
            (step, step, step),
        )
        bits = bits + jnp.uint8(1 << k) * (corner > iso).astype(jnp.uint8)
    bits = bits.transpose(2, 1, 0).reshape(-1)  # local (z, y, x) cell order
    # case 0 <=> bits in {0, 255} (see mesh/marching_cubes._classify_slab):
    # two compares instead of a LUT gather over every cell.
    kz = jnp.arange(bits.shape[0], dtype=jnp.int32) // (lx * ly)
    mask = (
        (bits != jnp.uint8(0))
        & (bits != jnp.uint8(255))
        & (d0_cells + kz < lz)
    )
    return bits, mask


def _halo_exchange(local, tail, step: int, n: int, axis: str):
    """Append the next brick's first ``step`` z-layers (ppermute); the last
    brick takes the replicated grid-tail strip instead."""
    if n > 1:
        perm = [(i, i - 1) for i in range(1, n)]
        halo = jax.lax.ppermute(
            jax.lax.slice_in_dim(local, 0, step, axis=2), axis, perm
        )
        is_last = jax.lax.axis_index(axis) == n - 1
        halo = jnp.where(
            jnp.reshape(is_last, (1,) * local.ndim), tail, halo
        )
    else:
        halo = tail
    return jnp.concatenate([local, halo], axis=2)


def _brick_layout(nz: int, step: int, n: int):
    """Visited z cells split into n equal bricks of m cell layers each."""
    lz = len(range(0, nz - step, step))
    m = -(-lz // n)  # cell layers per device
    return lz, m, m * step  # lz, m, z-layers per device


def _pad_z(arr, nz_pad: int):
    """Edge-pad axis 2 to ``nz_pad`` layers (padding is never read by real
    cells: their corners stop at nz-1)."""
    pad = nz_pad - arr.shape[2]
    if pad <= 0:
        return arr[:, :, :nz_pad] if pad < 0 else arr
    widths = [(0, 0), (0, 0), (0, pad)] + [(0, 0)] * (arr.ndim - 3)
    return jnp.pad(arr, widths, mode="edge")


def create_mesh_sharded(mesh: Mesh, voxels, iso_value: float = 0.0,
                        step: int = 1, progress=None) -> TriMesh:
    """Extract the iso-surface with the dense phase sharded over ``mesh``.

    Drop-in for mesh/marching_cubes.create_mesh: same semantics, same golden
    vertex counts, bit-identical output for any device count. Two SPMD
    dispatches: a count pass (classify only, per-device active counts out),
    then a gather pass at the host-chosen static bucket size (classify +
    compact + 8-corner value/color gather). Device→host transfer is
    O(surface), as in the single-device path.
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    iso = float(np.float32(iso_value))
    step = int(step)
    values = jnp.asarray(voxels.values, jnp.float32)
    colors = jnp.asarray(voxels.colors, jnp.float32)
    nx, ny, nz = values.shape
    lx = len(range(0, nx - step, step))
    ly = len(range(0, ny - step, step))

    if progress is not None:
        progress(0.0)
    if lx == 0 or ly == 0 or nz - step <= 0:
        if progress is not None:
            progress(1.0)
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
                       np.zeros(0))

    lz, m, nzL = _brick_layout(nz, step, n)
    # Sharded body: n bricks of nzL layers; replicated tail strip: the step
    # halo layers the LAST brick needs (global z in [n*nzL, n*nzL + step)).
    # Colors never enter the dense phase: vertex colors are interpolated on
    # device from the resident grid inside _sparse_phase, exactly as in the
    # single-device path.
    body_v = _pad_z(values, n * nzL)
    tail_v = _pad_z(values, n * nzL + step)[:, :, n * nzL:]
    zshard = NamedSharding(mesh, P(None, None, axis))
    body_v = jax.device_put(body_v, zshard)

    iso32 = jnp.float32(iso)

    def count_pass(body_v, tail_v):
        ext = _halo_exchange(body_v, tail_v, step, n, axis)
        d0 = jax.lax.axis_index(axis).astype(jnp.int32) * m
        _, mask = _classify_brick(ext, iso32, d0, step, lx, ly, m, lz)
        return jnp.sum(mask.astype(jnp.int32)).reshape(1)

    counts = jax.jit(
        jax.shard_map(
            count_pass, mesh=mesh,
            in_specs=(P(None, None, axis), P()),
            out_specs=P(axis),
        )
    )(body_v, tail_v)
    counts = np.asarray(counts)
    max_count = int(counts.max())
    if max_count == 0:
        if progress is not None:
            progress(1.0)
        return TriMesh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)),
                       np.zeros(0))
    size = 1 << max(max_count - 1, 0).bit_length()  # pow2 buckets bound recompiles

    def gather_pass(body_v, tail_v):
        ext_v = _halo_exchange(body_v, tail_v, step, n, axis)
        d0 = jax.lax.axis_index(axis).astype(jnp.int32) * m
        bits, mask = _classify_brick(
            ext_v, iso32, d0, step, lx, ly, m, lz
        )
        idx = jnp.nonzero(mask, size=size, fill_value=0)[0]
        cx = (idx % lx) * step
        cy = ((idx // lx) % ly) * step
        cz = (idx // (lx * ly)) * step  # brick-local z
        v8 = jnp.stack(
            [ext_v[cx + step * int(luts.CORNER_DX[k]),
                   cy + step * int(luts.CORNER_DY[k]),
                   cz + step * int(luts.CORNER_DZ[k])]
             for k in range(8)]
        )
        one = lambda a: a[None]
        return one(idx), one(bits[idx]), one(v8)

    idx_g, bits_g, v8_g = jax.jit(
        jax.shard_map(
            gather_pass, mesh=mesh,
            in_specs=(P(None, None, axis), P()),
            out_specs=(P(axis), P(axis), P(axis)),
        )
    )(body_v, tail_v)
    idx_g = np.asarray(idx_g)
    bits_g = np.asarray(bits_g)
    v8_g = np.asarray(v8_g)

    # Device bricks own disjoint ascending z ranges and are (z, y, x)-ordered
    # inside, so concatenation IS the single-device cell order.
    cells_per_brick = m * lx * ly
    active = np.concatenate(
        [idx_g[d, : counts[d]].astype(np.int64) + d * cells_per_brick
         for d in range(n)]
    )
    case_index = np.concatenate(
        [bits_g[d, : counts[d]] for d in range(n)]
    ).astype(np.int64)
    v8 = np.concatenate(
        [v8_g[d, :, : counts[d]] for d in range(n)], axis=1
    )

    tri = _sparse_phase(voxels, active, case_index, v8, colors, step, lx, ly,
                        iso)
    if progress is not None:
        progress(1.0)
    return tri
