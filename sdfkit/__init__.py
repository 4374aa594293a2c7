"""sdfkit — a differentiable signed-distance-field framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of
praeclarum/SdfKit: a jit-traceable SDF expression DSL (primitives, CSG
including smooth union, domain repetition with per-instance color), a
sphere-tracing renderer with finite-difference normals and diffuse shading
(jnp reference path + fused Pallas GPU kernels), dense voxel-grid sampling and
Lewiner MC33 marching-cubes mesh extraction with color interpolation and OBJ
export, and Kabsch-SVD iterative-closest-point registration — scaling to
multi-device meshes via shard_map.
"""

from sdfkit.sdf import expr as sdf
from sdfkit.sdf.expr import (
    Box,
    Capsule,
    Cylinder,
    Plane,
    SdfExpr,
    Sphere,
    Torus,
    box,
    capsule,
    cylinder,
    plane,
    plane_xy,
    plane_xz,
    solid,
    sphere,
    torus,
    union,
)
from sdfkit.fit import fit
from sdfkit.ops.grid import voxelize
from sdfkit.sdf.sample import sample
from sdfkit.mesh.mesh import Mesh
from sdfkit.mesh.voxels import Voxels
from sdfkit.render.raymarch import RayMarcher, render, render_depth
from sdfkit.utils.camera import look_at, perspective_fov
from sdfkit.utils.v3 import V3

__version__ = "0.1.0"

__all__ = [
    "Box",
    "Capsule",
    "Cylinder",
    "Mesh",
    "Plane",
    "RayMarcher",
    "SdfExpr",
    "Sphere",
    "Torus",
    "V3",
    "Voxels",
    "box",
    "capsule",
    "cylinder",
    "fit",
    "look_at",
    "perspective_fov",
    "plane",
    "plane_xy",
    "plane_xz",
    "render",
    "render_depth",
    "sample",
    "sdf",
    "solid",
    "sphere",
    "torus",
    "union",
    "voxelize",
]
