"""Voxel volume container (reference: SdfKit/Voxels.cs)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Voxels:
    """A regular 3-D grid of distance values and colors with world bounds.

    ``values``: (nx, ny, nz) float32 signed distances at cell centers.
    ``colors``: (nx, ny, nz, 3) float32 RGB.
    Cell sizes DX/DY/DZ = size/n (reference: Voxels.cs:32-34).
    """

    values: jnp.ndarray
    colors: jnp.ndarray
    vmin: jnp.ndarray
    vmax: jnp.ndarray

    def tree_flatten(self):
        return (self.values, self.colors, self.vmin, self.vmax), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- bounds (IBoundedVolume parity, IBoundedVolume.cs:6-13) ----------
    @property
    def nx(self) -> int:
        return self.values.shape[0]

    @property
    def ny(self) -> int:
        return self.values.shape[1]

    @property
    def nz(self) -> int:
        return self.values.shape[2]

    @property
    def size(self):
        return self.vmax - self.vmin

    @property
    def center(self):
        return (self.vmin + self.vmax) * 0.5

    @property
    def radius(self):
        return float(jnp.linalg.norm(self.size) * 0.5)

    @property
    def d(self):
        return self.size / jnp.array(
            [self.nx, self.ny, self.nz], dtype=jnp.float32
        )

    def host_bounds(self):
        """(size, center) as float64 numpy, fetched from device once and
        cached. The f32 host arithmetic matches the device's bit-for-bit
        (same IEEE ops), so meshes finalize identically; the cache spares
        repeat to_mesh calls two device round trips each."""
        cache = getattr(self, "_host_bounds", None)
        if cache is None:
            vmin = np.asarray(self.vmin, np.float32)
            vmax = np.asarray(self.vmax, np.float32)
            cache = (
                (vmax - vmin).astype(np.float64),
                ((vmin + vmax) * np.float32(0.5)).astype(np.float64),
            )
            object.__setattr__(self, "_host_bounds", cache)
        return cache

    def clip_to_bounds(self) -> "Voxels":
        from sdfkit.ops.grid import clip_values_to_bounds

        return dataclasses.replace(
            self, values=clip_values_to_bounds(self.values, self.vmin, self.vmax)
        )

    def value_at(self, p) -> float:
        """World-space indexer (reference: Voxels.cs:48-65): floor to cell."""
        p = np.asarray(p, np.float32)
        d = np.asarray(self.d)
        vmin = np.asarray(self.vmin)
        idx = ((p - vmin) / d).astype(np.int32)
        return float(np.asarray(self.values)[idx[0], idx[1], idx[2]])

    def to_mesh(self, iso_value: float = 0.0, step: int = 1, progress=None):
        from sdfkit.mesh.marching_cubes import create_mesh

        return create_mesh(self, iso_value=iso_value, step=step, progress=progress)

    # -- persistence (the reference has no Voxels save/load; dense grids
    # are expensive to recompute, so checkpointing them is our analogue of
    # SURVEY §5's render/voxelize-output persistence plan) ----------------
    def save(self, path) -> None:
        """Persist the volume as a compressed .npz archive."""
        np.savez_compressed(
            path,
            values=np.asarray(self.values, np.float32),
            colors=np.asarray(self.colors, np.float32),
            vmin=np.asarray(self.vmin, np.float32),
            vmax=np.asarray(self.vmax, np.float32),
        )

    @classmethod
    def load(cls, path) -> "Voxels":
        with np.load(path) as z:
            return cls(
                values=jnp.asarray(z["values"]),
                colors=jnp.asarray(z["colors"]),
                vmin=jnp.asarray(z["vmin"]),
                vmax=jnp.asarray(z["vmax"]),
            )
