"""Traceable SDF expression DSL — the JAX analogue of SdfKit's
three-tier SDF representation.

The reference (praeclarum/SdfKit) carries SDFs in three tiers: batched
delegates (`Sdf`, Sdf.cs:8), scalar funcs (`SdfFunc`, Sdf.cs:7) and LINQ
expression trees runtime-compiled to fused batched IL loops
(`SdfExpr`/`SdfExprCompiler`, SdfExpr.cs:225-273). Under JAX the three tiers
collapse into one: an :class:`SdfExpr` here is a pytree of parameters plus a
pure traced ``eval`` — `jax.jit` plays the role of the reference's expression
compiler (tracing fuses the whole tree into one XLA computation), `vmap`-style
array semantics play the role of its batch loop, and because parameters are
pytree leaves every expression is differentiable end-to-end.

Evaluation protocol (structure-of-arrays, see utils/v3.py):

    expr.eval(p: V3) -> (color: V3, dist: Array)      # any component shape
    expr(points)     -> (..., 4) array                # rgb in [...,:3], dist in [...,3]

matching the reference's ``Vector4`` convention of RGB in XYZ and signed
distance in W (GlobalUsings.cs:10-14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

from sdfkit.utils.v3 import V3, vmod

Array = Any


def _register(cls, data_fields: Sequence[str], static_fields: Sequence[str] = ()):
    """Register an SdfExpr dataclass as a pytree with parameter leaves."""

    def flatten(obj):
        return tuple(getattr(obj, f) for f in data_fields), tuple(
            getattr(obj, f) for f in static_fields
        )

    def unflatten(aux, children):
        kwargs = dict(zip(data_fields, children))
        kwargs.update(dict(zip(static_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def sdf_node(data_fields: Sequence[str], static_fields: Sequence[str] = ()):
    def deco(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        return _register(cls, data_fields, static_fields)

    return deco


def _f32(v) -> Array:
    return jnp.asarray(v, dtype=jnp.float32)


def _color3(c) -> Array:
    """Normalize a color spec (scalar, 3-seq, or array) to a (3,) f32 array."""
    c = jnp.asarray(c, dtype=jnp.float32)
    if c.ndim == 0:
        c = jnp.broadcast_to(c, (3,))
    return c


class SdfExpr:
    """Base class: a differentiable, jit-traceable signed distance field."""

    # -- protocol ---------------------------------------------------------
    def eval(self, p: V3) -> tuple[V3, Array]:
        raise NotImplementedError

    def distance(self, p: V3) -> Array:
        return self.eval(p)[1]

    def __call__(self, points: Array) -> Array:
        """Batched evaluation: (..., 3) points -> (..., 4) rgb+distance."""
        p = V3.from_array(jnp.asarray(points, dtype=jnp.float32))
        color, dist = self.eval(p)
        color = V3(
            jnp.broadcast_to(color.x, dist.shape),
            jnp.broadcast_to(color.y, dist.shape),
            jnp.broadcast_to(color.z, dist.shape),
        )
        return jnp.stack([color.x, color.y, color.z, dist], axis=-1)

    # -- CSG combinators --------------------------------------------------
    def union(self, other: "SdfExpr") -> "SdfExpr":
        return Union(self, other)

    def __or__(self, other):
        return self.union(other)

    def intersect(self, other: "SdfExpr") -> "SdfExpr":
        return Intersection(self, other)

    def __and__(self, other):
        return self.intersect(other)

    def subtract(self, other: "SdfExpr") -> "SdfExpr":
        return Subtraction(self, other)

    def smooth_union(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothUnion(self, other, _f32(k))

    def smooth_intersect(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothIntersection(self, other, _f32(k))

    def smooth_subtract(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothSubtraction(self, other, _f32(k))

    # -- domain modifiers -------------------------------------------------
    def translate(self, x, y=None, z=None) -> "SdfExpr":
        """Reference: SdfFuncEx.Translate (Sdf.cs:315-326)."""
        if y is None:
            off = _color3(x)
        else:
            off = jnp.stack([_f32(x), _f32(y), _f32(z)])
        return Translate(self, off)

    def scale(self, s) -> "SdfExpr":
        return Scale(self, _f32(s))

    def rotate_x(self, angle) -> "SdfExpr":
        return Rotate(self, axis="x", angle=_f32(angle))

    def rotate_y(self, angle) -> "SdfExpr":
        return Rotate(self, axis="y", angle=_f32(angle))

    def rotate_z(self, angle) -> "SdfExpr":
        return Rotate(self, axis="z", angle=_f32(angle))

    def round(self, radius) -> "SdfExpr":
        """Rounded offset surface: d - r (grows the shape by r with rounded
        edges). The radius is a differentiable parameter."""
        return Round(self, _f32(radius))

    def shell(self, thickness) -> "SdfExpr":
        """Hollow shell of the surface: |d| - t/2."""
        return Shell(self, _f32(thickness))

    def modify_input(self, fn: Callable[[V3], V3]) -> "SdfExpr":
        """Position warp (reference: SdfExprEx.ModifyInput, SdfExpr.cs:79-89)."""
        return ModifyInput(self, fn)

    def modify_output(self, fn: Callable[[V3, V3, Array], V3]) -> "SdfExpr":
        """Color rewrite ``fn(p, color, dist) -> color`` (reference:
        SdfExprEx.ModifyOutput, SdfExpr.cs:91-111)."""
        return ModifyOutput(self, fn)

    def modify_input_and_output(self, fn_in, fn_out) -> "SdfExpr":
        """``fn_in(p) -> (warped: V3, index: V3)``;
        ``fn_out(index, warped_p, color, dist) -> color``
        (reference: SdfExprEx.ModifyInputAndOutput, SdfExpr.cs:113-141)."""
        return ModifyInputAndOutput(self, fn_in, fn_out)

    def color(self, r, g=None, b=None) -> "SdfExpr":
        """Override output color (reference: SdfExprEx.Color, SdfExpr.cs:143-147;
        SdfFuncEx.WithColor, Sdf.cs:328-340)."""
        if g is None:
            c = _color3(r)
        else:
            c = jnp.stack([_f32(r), _f32(g), _f32(b)])
        return WithColor(self, c)

    with_color = color

    # Domain repetition. Formula from the reference (SdfExpr.cs:149-201):
    #   p' = mod(p + size/2, size) - size/2
    #   cell index i = floor((p + size/2) / size)     (floor-mod semantics)
    def repeat_x(self, size_x) -> "SdfExpr":
        return Repeat(self, axes="x", sizes=(_f32(size_x),), color_fn=None)

    def repeat_y(self, size_y) -> "SdfExpr":
        return Repeat(self, axes="y", sizes=(_f32(size_y),), color_fn=None)

    def repeat_xy(self, size_x, size_y, color_fn=None) -> "SdfExpr":
        """``color_fn(index: V3, p: V3, color: V3, dist) -> V3`` per-cell color
        (reference: RepeatXY with SdfIndexedOutputModifierFunc, SdfExpr.cs:163-178)."""
        return Repeat(
            self, axes="xy", sizes=(_f32(size_x), _f32(size_y)), color_fn=color_fn
        )

    def repeat_xz(self, size_x, size_z, color_fn=None) -> "SdfExpr":
        return Repeat(
            self, axes="xz", sizes=(_f32(size_x), _f32(size_z)), color_fn=color_fn
        )

    def repeat_xyz(self, size_x, size_y, size_z, color_fn=None) -> "SdfExpr":
        return Repeat(
            self,
            axes="xyz",
            sizes=(_f32(size_x), _f32(size_y), _f32(size_z)),
            color_fn=color_fn,
        )

    def repeat_indexed(self, axes: str, sizes, table, index_fn=None,
                       combine: str = "replace") -> "SdfExpr":
        """Domain repetition with a DIFFERENTIABLE per-cell palette: the
        color of each cell is a row of ``table`` (a (T, 3) pytree data
        leaf), so ``fit()`` can optimize the palette itself — the
        trainable analogue of ``repeat_*(color_fn=...)`` whose closures
        are static aux (any array they capture is a baked constant).
        Reference counterpart: the SdfIndexedOutputModifierFunc color
        hooks (SdfExpr.cs:163-178), made optimizable. See
        RepeatIndexedColor."""
        if combine not in ("replace", "multiply"):
            raise ValueError(f"unknown combine mode {combine!r}")
        if any(a not in "xyz" for a in axes) or not axes:
            raise ValueError(f"axes must be a subset of 'xyz', got {axes!r}")
        sizes = tuple(sizes)  # bind once: the caller may pass an iterator
        if len(sizes) != len(axes):
            raise ValueError(
                f"got {len(sizes)} sizes for {len(axes)} axes "
                f"({axes!r}) — zip would silently drop the rest"
            )
        return RepeatIndexedColor(
            self,
            sizes=tuple(_f32(s) for s in sizes),
            table=jnp.asarray(table, jnp.float32),
            axes=axes,
            index_fn=index_fn,
            combine=combine,
        )

    # -- conversions (mirror SdfEx, Sdf.cs:49-115) ------------------------
    def sample(self, points: Array, batch_size: int | None = None) -> Array:
        """Evaluate at (N, 3) points in fixed-size batches (the reference's
        batch sampling driver, SdfEx.Sample, Sdf.cs:22-47)."""
        from sdfkit.sdf.sample import DEFAULT_BATCH_SIZE, sample

        return sample(
            self, points, DEFAULT_BATCH_SIZE if batch_size is None else batch_size
        )

    def to_sdf(self) -> Callable[[Array], Array]:
        """A jitted batched callable (the reference's compiled tier;
        SdfExprCompiler.Compile, SdfExpr.cs:234-238 — here jax.jit does the
        fusion)."""
        return jax.jit(self.__call__)

    def to_voxels(self, vmin, vmax, nx, ny, nz, clip_to_bounds=True):
        from sdfkit.ops.grid import voxelize

        return voxelize(self, vmin, vmax, nx, ny, nz, clip_to_bounds=clip_to_bounds)

    def to_mesh(
        self,
        vmin,
        vmax,
        nx,
        ny,
        nz,
        clip_to_bounds=True,
        iso_value=0.0,
        step=1,
        progress=None,
    ):
        v = self.to_voxels(vmin, vmax, nx, ny, nz, clip_to_bounds=clip_to_bounds)
        return v.to_mesh(iso_value=iso_value, step=step, progress=progress)

    def to_image(self, width, height, camera=None, **kwargs):
        from sdfkit.render.raymarch import RayMarcher

        return RayMarcher(width, height, self, **kwargs).render(camera=camera)


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


@sdf_node(["radius", "rgb"])
class Sphere(SdfExpr):
    """Exact sphere: |p| - r (reference: Sdfs.Sphere, Sdf.cs:202-214)."""

    radius: Array
    rgb: Array

    def eval(self, p: V3):
        return V3.splat(self.rgb), p.length() - self.radius


@sdf_node(["bounds", "rgb"])
class Box(SdfExpr):
    """Exact box: |max(q,0)| + min(max(q.x,q.y,q.z), 0), q = |p| - b
    (reference: Sdfs.Box, Sdf.cs:125-139)."""

    bounds: Array
    rgb: Array

    def eval(self, p: V3):
        b = V3.splat(self.bounds)
        wd = p.abs() - b
        # zero_safe_length: |max(wd,0)| is exactly 0 everywhere inside the
        # box; plain sqrt there has an inf derivative that NaNs reverse mode.
        outside = wd.max(0.0).zero_safe_length()
        inside = wd.min(0.0).vmax()
        return V3.splat(self.rgb), outside + inside


@sdf_node(["radius", "height", "rgb"])
class Cylinder(SdfExpr):
    """Y-axis cylinder: max(sqrt(x²+z²) - r, |y| - h)
    (reference: SdfExprs.Cylinder, SdfExpr.cs:28-32)."""

    radius: Array
    height: Array
    rgb: Array

    def eval(self, p: V3):
        radial = jnp.sqrt(p.x * p.x + p.z * p.z) - self.radius
        axial = jnp.abs(p.y) - self.height
        return V3.splat(self.rgb), jnp.maximum(radial, axial)


@sdf_node(["normal", "offset", "rgb"])
class Plane(SdfExpr):
    """Half-space: dot(p, n) + d (reference: Sdfs.Plane, Sdf.cs:144-156)."""

    normal: Array
    offset: Array
    rgb: Array

    def eval(self, p: V3):
        n = V3.splat(self.normal)
        return V3.splat(self.rgb), p.dot(n) + self.offset


@sdf_node(["rgb"], ["fn"])
class Solid(SdfExpr):
    """Wrap a plain distance function ``fn(p: V3) -> Array``
    (reference: Sdfs.Solid / SdfExprs.Solid, Sdf.cs:172-200, SdfExpr.cs:34-45)."""

    rgb: Array
    fn: Callable[[V3], Array]

    def eval(self, p: V3):
        return V3.splat(self.rgb), self.fn(p)


@sdf_node(["rgb", "radii"])
class Torus(SdfExpr):
    """Torus in XZ plane: |(len(p.xz) - R, p.y)| - r. radii = (R, r)."""

    rgb: Array
    radii: Array

    def eval(self, p: V3):
        big, small = self.radii[0], self.radii[1]
        q = jnp.sqrt(p.x * p.x + p.z * p.z) - big
        return V3.splat(self.rgb), jnp.sqrt(q * q + p.y * p.y) - small


@sdf_node(["a", "b", "radius", "rgb"])
class Capsule(SdfExpr):
    """Capsule between points a and b with the given radius."""

    a: Array
    b: Array
    radius: Array
    rgb: Array

    def eval(self, p: V3):
        a = V3.splat(self.a)
        b = V3.splat(self.b)
        pa = p - a
        ba = b - a
        h = jnp.clip(pa.dot(ba) / ba.dot(ba), 0.0, 1.0)
        return V3.splat(self.rgb), (pa - ba * h).length() - self.radius


# ---------------------------------------------------------------------------
# CSG.
# ---------------------------------------------------------------------------


@sdf_node(["a", "b"])
class Union(SdfExpr):
    """Pick whichever output has the smaller distance
    (reference: SdfExprs.Union, SdfExpr.cs:54-68: ``da.W < db.W ? da : db``)."""

    a: SdfExpr
    b: SdfExpr

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        mask = da < db
        return ca.where(mask, cb), jnp.minimum(da, db)


@sdf_node(["a", "b"])
class Intersection(SdfExpr):
    a: SdfExpr
    b: SdfExpr

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        mask = da > db
        return ca.where(mask, cb), jnp.maximum(da, db)


@sdf_node(["a", "b"])
class Subtraction(SdfExpr):
    """a minus b: max(da, -db); color follows a."""

    a: SdfExpr
    b: SdfExpr

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        _, db = self.b.eval(p)
        return ca, jnp.maximum(da, -db)


def _smooth_mix(da, db, k, sign):
    """Polynomial smooth min (iq). sign=+1 union, -1 intersection."""
    h = jnp.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    d = _lerp(sign * db, sign * da, h) - k * h * (1.0 - h)
    return sign * d, h


def _lerp(a, b, t):
    return a + (b - a) * t


@sdf_node(["a", "b", "k"])
class SmoothUnion(SdfExpr):
    """Polynomial smooth union with color blending (differentiable CSG;
    BASELINE.json north-star capability, no reference counterpart)."""

    a: SdfExpr
    b: SdfExpr
    k: Array

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        d, h = _smooth_mix(da, db, self.k, 1.0)
        color = V3(
            _lerp(cb.x, ca.x, h), _lerp(cb.y, ca.y, h), _lerp(cb.z, ca.z, h)
        )
        return color, d


@sdf_node(["a", "b", "k"])
class SmoothIntersection(SdfExpr):
    a: SdfExpr
    b: SdfExpr
    k: Array

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        d, h = _smooth_mix(da, db, self.k, -1.0)
        color = V3(
            _lerp(cb.x, ca.x, h), _lerp(cb.y, ca.y, h), _lerp(cb.z, ca.z, h)
        )
        return color, d


@sdf_node(["a", "b", "k"])
class SmoothSubtraction(SdfExpr):
    a: SdfExpr
    b: SdfExpr
    k: Array

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        _, db = self.b.eval(p)
        h = jnp.clip(0.5 - 0.5 * (da + db) / self.k, 0.0, 1.0)
        d = _lerp(da, -db, h) + self.k * h * (1.0 - h)
        return ca, d


# ---------------------------------------------------------------------------
# Modifiers.
# ---------------------------------------------------------------------------


@sdf_node(["child", "offset"])
class Translate(SdfExpr):
    child: SdfExpr
    offset: Array

    def eval(self, p: V3):
        return self.child.eval(p - V3.splat(self.offset))


@sdf_node(["child", "factor"])
class Scale(SdfExpr):
    """Uniform scale; distance corrected by the factor to stay a metric SDF."""

    child: SdfExpr
    factor: Array

    def eval(self, p: V3):
        c, d = self.child.eval(p / self.factor)
        return c, d * self.factor


@sdf_node(["child", "angle"], ["axis"])
class Rotate(SdfExpr):
    """Rotate the shape about a coordinate axis by ``angle`` radians (the
    domain is rotated by -angle). Distances are preserved (rigid motion), and
    the angle is a differentiable parameter — pose fitting works through it.
    The reference reaches rotations via ModifyInput position warps
    (SdfExpr.cs:79-89); a rigid rotation is the common case so it gets a node.
    """

    child: SdfExpr
    angle: Array
    axis: str

    def eval(self, p: V3):
        c = jnp.cos(self.angle)
        s = jnp.sin(self.angle)
        if self.axis == "x":
            q = V3(p.x, c * p.y + s * p.z, -s * p.y + c * p.z)
        elif self.axis == "y":
            q = V3(c * p.x - s * p.z, p.y, s * p.x + c * p.z)
        else:
            q = V3(c * p.x + s * p.y, -s * p.x + c * p.y, p.z)
        return self.child.eval(q)


@sdf_node(["child", "radius"])
class Round(SdfExpr):
    child: SdfExpr
    radius: Array

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return c, d - self.radius


@sdf_node(["child", "thickness"])
class Shell(SdfExpr):
    child: SdfExpr
    thickness: Array

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return c, jnp.abs(d) - self.thickness * 0.5


@sdf_node(["child"], ["fn"])
class ModifyInput(SdfExpr):
    child: SdfExpr
    fn: Callable[[V3], V3]

    def eval(self, p: V3):
        return self.child.eval(self.fn(p))


@sdf_node(["child"], ["fn"])
class ModifyOutput(SdfExpr):
    child: SdfExpr
    fn: Callable[[V3, V3, Array], V3]

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return self.fn(p, c, d), d


@sdf_node(["child"], ["fn_in", "fn_out"])
class ModifyInputAndOutput(SdfExpr):
    child: SdfExpr
    fn_in: Callable[[V3], tuple[V3, V3]]
    fn_out: Callable[[V3, V3, V3, Array], V3]

    def eval(self, p: V3):
        warped, index = self.fn_in(p)
        c, d = self.child.eval(warped)
        return self.fn_out(index, warped, c, d), d


@sdf_node(["child", "rgb"])
class WithColor(SdfExpr):
    child: SdfExpr
    rgb: Array

    def eval(self, p: V3):
        _, d = self.child.eval(p)
        return V3.splat(self.rgb), d


@sdf_node(["child", "sizes"], ["axes", "color_fn"])
class Repeat(SdfExpr):
    """Domain repetition along the given axes with optional per-cell coloring.

    p' = mod(p + s/2, s) - s/2, cell index = floor((p + s/2)/s)
    (reference: SdfExprEx.RepeatX/Y/XY/XZ, SdfExpr.cs:149-201).
    """

    child: SdfExpr
    sizes: tuple
    axes: str
    color_fn: Callable[[V3, V3, V3, Array], V3] | None

    def eval(self, p: V3):
        comps = {"x": p.x, "y": p.y, "z": p.z}
        idx = {"x": jnp.zeros_like(p.x), "y": jnp.zeros_like(p.y), "z": jnp.zeros_like(p.z)}
        for axis, size in zip(self.axes, self.sizes):
            half = size * 0.5
            comps[axis] = vmod(comps[axis] + half, size) - half
            idx[axis] = jnp.floor((getattr(p, axis) + half) / size)
        warped = V3(comps["x"], comps["y"], comps["z"])
        c, d = self.child.eval(warped)
        if self.color_fn is not None:
            c = self.color_fn(V3(idx["x"], idx["y"], idx["z"]), warped, c, d)
        return c, d


@sdf_node(["child", "sizes", "table"], ["axes", "index_fn", "combine"])
class RepeatIndexedColor(SdfExpr):
    """Domain repetition whose per-cell color comes from a differentiable
    palette.

    Same warp/index formula as :class:`Repeat` (SdfExpr.cs:149-201), but the
    cell's color is ``table[index_fn(ix, iy, iz) mod T]`` where ``table`` is
    a (T, 3) pytree DATA leaf — its rows receive gradients, so ``fit()`` can
    optimize the palette of a repeated scene (the differentiable analogue of
    the reference's SdfIndexedOutputModifierFunc hooks, SdfExpr.cs:163-178,
    whose closures here are static aux and therefore invisible to the
    optimizer).

    ``index_fn(ix, iy, iz) -> Array`` is STATIC structure (it maps integer
    cell coordinates to an integer-valued float table position; default
    ``ix + iy + iz``, a diagonal stripe). The palette row is selected by a
    one-hot blend — Σ_t (pos == t) · table[t] — rather than a gather: the
    fused GPU kernels rebuild ``table`` from scalar loads inside the kernel,
    where a static unrolled blend is plain elementwise math and a per-pixel
    dynamic gather would not lower. T is the palette size (static via the
    leaf's shape); keep it modest (≲64) — the blend unrolls T fused
    multiply-adds per pixel in the final shade only (the march loop consumes
    distances, so the color math is dead code the compiler strips there).

    ``combine``: 'replace' swaps the child color for the palette row;
    'multiply' modulates the child color by it (both differentiable).
    """

    child: SdfExpr
    sizes: tuple
    table: Array
    axes: str
    index_fn: Callable[[Array, Array, Array], Array] | None
    combine: str

    def eval(self, p: V3):
        comps = {"x": p.x, "y": p.y, "z": p.z}
        idx = {
            "x": jnp.zeros_like(p.x),
            "y": jnp.zeros_like(p.y),
            "z": jnp.zeros_like(p.z),
        }
        for axis, size in zip(self.axes, self.sizes):
            half = size * 0.5
            comps[axis] = vmod(comps[axis] + half, size) - half
            idx[axis] = jnp.floor((getattr(p, axis) + half) / size)
        warped = V3(comps["x"], comps["y"], comps["z"])
        c, d = self.child.eval(warped)

        if self.index_fn is None:
            pos = idx["x"] + idx["y"] + idx["z"]
        else:
            pos = self.index_fn(idx["x"], idx["y"], idx["z"])
        t_count = self.table.shape[0]
        # Floor-mod into [0, T): cell indices are exact small integers in
        # f32, so the equality selects below are exact.
        pos = pos - jnp.floor(pos / t_count) * t_count
        cr = cg = cb = jnp.zeros_like(d)
        for t in range(t_count):
            w = (pos == t).astype(d.dtype)
            cr = cr + w * self.table[t, 0]
            cg = cg + w * self.table[t, 1]
            cb = cb + w * self.table[t, 2]
        if self.combine == "multiply":
            color = V3(c.x * cr, c.y * cg, c.z * cb)
        else:
            color = V3(
                jnp.broadcast_to(cr, d.shape),
                jnp.broadcast_to(cg, d.shape),
                jnp.broadcast_to(cb, d.shape),
            )
        return color, d


# ---------------------------------------------------------------------------
# Convenience constructors mirroring the reference's static classes.
# ---------------------------------------------------------------------------

_WHITE = (1.0, 1.0, 1.0)


def sphere(radius, color=_WHITE) -> Sphere:
    return Sphere(_f32(radius), _color3(color))


def box(bounds, color=_WHITE) -> Box:
    return Box(_color3(bounds), _color3(color))


def cylinder(radius, height, color=_WHITE) -> Cylinder:
    return Cylinder(_f32(radius), _f32(height), _color3(color))


def plane(normal, offset=0.0, color=_WHITE) -> Plane:
    return Plane(_color3(normal), _f32(offset), _color3(color))


def plane_xy(z=0.0, color=_WHITE) -> Plane:
    """Reference: Sdfs.PlaneXY (Sdf.cs:158-163)."""
    return plane((0.0, 0.0, 1.0), z, color)


def plane_xz(y=0.0, color=_WHITE) -> Plane:
    """Reference: Sdfs.PlaneXZ (Sdf.cs:165-170)."""
    return plane((0.0, 1.0, 0.0), y, color)


def solid(fn, color=_WHITE) -> Solid:
    return Solid(_color3(color), fn)


def torus(big_radius, small_radius, color=_WHITE) -> Torus:
    return Torus(_color3(color), jnp.stack([_f32(big_radius), _f32(small_radius)]))


def capsule(a, b, radius, color=_WHITE) -> Capsule:
    return Capsule(_color3(a), _color3(b), _f32(radius), _color3(color))


def union(*exprs: SdfExpr) -> SdfExpr:
    out = exprs[0]
    for e in exprs[1:]:
        out = Union(out, e)
    return out
