"""Multi-chip scaling surface: 1-D domain decompositions over a device mesh
(SURVEY §5 — ray tiles, voxel bricks with halos, replicated params with
psum'd grads), plus multi-host initialization helpers."""

from sdfkit.parallel.distributed import initialize, make_mesh
from sdfkit.parallel.elastic import render_tiles_resumable
from sdfkit.parallel.marching import create_mesh_sharded
from sdfkit.parallel.train import (
    render_sharded,
    train_step_sharded,
    voxelize_sharded,
)

__all__ = [
    "create_mesh_sharded",
    "initialize",
    "make_mesh",
    "render_sharded",
    "render_tiles_resumable",
    "train_step_sharded",
    "voxelize_sharded",
]
