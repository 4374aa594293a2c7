"""Sphere-tracing renderer (pure-jnp path).

Reproduces the reference RayMarcher semantics exactly
(reference: SdfKit/RayMarcher.cs):

* depth starts at ``near - 0.1`` (RayMarcher.cs:85,136);
* a **fixed** number of march iterations with *no* early exit and *no* hit
  threshold — misses keep accumulating depth past the far plane
  (RayMarcher.cs:86-92,138-145);
* the diffuse color is the RGB of the *last* march sample (RayMarcher.cs:142-144);
* normals from 6-tap central differences with eps 1e-5 (RayMarcher.cs:29,173-204);
* single point light at (5,5,10), Lambert ``max(dot(n,l),0)*diffuse + 0.1``
  (RayMarcher.cs:149-154);
* sky color (0.5, 0.75, 1.0) where ``depth > far`` (RayMarcher.cs:156-160).

The whole march runs under ``lax.fori_loop`` inside ``jit``: XLA fuses each
iteration's SDF evaluation into one elementwise kernel over the image. The
fused GPU kernels live in ``sdfkit.render.pallas``; this module is the
semantic reference and the autodiff path (everything here is differentiable
by construction).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from sdfkit.sdf.expr import SdfExpr
from sdfkit.utils.camera import camera_rays, default_view, look_at
from sdfkit.utils.v3 import V3

Array = Any

DEFAULT_NEAR = 1.0
DEFAULT_FAR = 100.0
DEFAULT_VFOV_DEGREES = 60.0
DEFAULT_DEPTH_ITERATIONS = 40
GRAD_OFFSET = 1e-5
LIGHT_POSITION = (5.0, 5.0, 10.0)
AMBIENT = 0.1
SKY_COLOR = (0.5, 0.75, 1.0)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's RayMarcher properties,
    RayMarcher.cs:9-31)."""

    width: int
    height: int
    vfov_degrees: float = DEFAULT_VFOV_DEGREES
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    depth_iterations: int = DEFAULT_DEPTH_ITERATIONS


def _march(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig, want_color: bool):
    """Fixed-iteration sphere trace. Returns (depth, last_sample_color).

    The last iteration runs outside the loop so the final sample's color is
    available without being loop-carried (reference takes the diffuse color
    from the last sample, RayMarcher.cs:142-144). The initial depth is derived
    from the rays (``ro.x * 0``) so the loop carry stays device-varying under
    shard_map.
    """
    depth = ro.x * 0.0 + jnp.float32(cfg.near - 0.1)

    def body_d(_, depth):
        pos = ro + rd * depth
        return depth + sdf.distance(pos)

    n = cfg.depth_iterations
    if not want_color:
        return jax.lax.fori_loop(0, n, body_d, depth), None

    depth = jax.lax.fori_loop(0, n - 1, body_d, depth)
    pos = ro + rd * depth
    color, dist = sdf.eval(pos)
    color = V3(
        jnp.broadcast_to(color.x, dist.shape),
        jnp.broadcast_to(color.y, dist.shape),
        jnp.broadcast_to(color.z, dist.shape),
    )
    return depth + dist, color


def _distance_gradient(sdf: SdfExpr, p: V3) -> V3:
    """6-tap central-difference gradient, eps matching the reference
    (RayMarcher.cs:29,164-204). Finite differences (not jax.grad) on purpose:
    pixel-parity with the reference requires the same estimator."""
    e = GRAD_OFFSET

    def d(dx, dy, dz):
        return sdf.distance(V3(p.x + dx, p.y + dy, p.z + dz))

    return V3(
        d(e, 0.0, 0.0) - d(-e, 0.0, 0.0),
        d(0.0, e, 0.0) - d(0.0, -e, 0.0),
        d(0.0, 0.0, e) - d(0.0, 0.0, -e),
    )


def render_depth_rays(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> Array:
    depth, _ = _march(sdf, ro, rd, cfg, want_color=False)
    return depth


def render_rays(sdf: SdfExpr, ro: V3, rd: V3, cfg: RenderConfig) -> Array:
    """Returns an (..., 3) RGB image for the given rays."""
    depth, diffuse = _march(sdf, ro, rd, cfg, want_color=True)

    bg = depth > cfg.far
    # Shade miss pixels at a benign depth: their real accumulated depth is
    # ~2^iterations sensitive to parameters, so reverse-mode through the
    # (masked-out) shading branch would overflow to inf and leak NaN via the
    # 0-cotangent-times-inf rule. Sanitizing the branch INPUT (not just the
    # output select) keeps the backward finite; hit pixels are untouched.
    shade_depth = jnp.where(bg, jnp.float32(cfg.near), depth)
    surface = ro + rd * shade_depth
    normal = _distance_gradient(sdf, surface).safe_normalize()
    light = (V3.splat(jnp.asarray(LIGHT_POSITION, jnp.float32)) - surface).safe_normalize()
    lambert = jnp.maximum(normal.dot(light), 0.0)
    lighting = diffuse * lambert + AMBIENT

    sky = V3.splat(jnp.asarray(SKY_COLOR, jnp.float32))
    color = lighting.where(~bg, sky)
    return color.to_array()


@partial(jax.jit, static_argnums=(2,))
def _render_impl(sdf, view, cfg):
    ro, rd = camera_rays(
        cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far
    )
    return render_rays(sdf, ro, rd, cfg)


@partial(jax.jit, static_argnums=(2,))
def _render_depth_impl(sdf, view, cfg):
    ro, rd = camera_rays(
        cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far
    )
    return render_depth_rays(sdf, ro, rd, cfg)


@partial(jax.jit, static_argnums=(2, 3, 4))
def _render_fused(sdf, view, cfg, interpret, depth_only):
    from sdfkit.render.pallas import raymarch_kernel as rk

    fn = rk.render_depth_image_fused if depth_only else rk.render_image_fused
    return fn(sdf, view, cfg, interpret)


class RayMarcher:
    """Object-style API mirroring the reference RayMarcher (RayMarcher.cs:7-40).

    ``render()`` returns an (H, W, 3) RGB array; ``render_depth()`` an (H, W)
    depth array. Both are jit-compiled; gradients flow to the SDF's pytree
    parameters and to the view matrix.

    Note on reference parity: ``backend='auto'`` picks the fused GPU kernels
    on a GPU, whose output matches the jnp path's math but rounds
    differently (the 40 compounding march steps amplify rounding
    differences to ~5e-2 on a few silhouette pixels). Pixel comparisons
    against reference/golden images should pass ``backend='jnp'`` — the
    semantic-reference path — explicitly.
    """

    def __init__(
        self,
        width: int,
        height: int,
        sdf: SdfExpr,
        view=None,
        vfov_degrees: float = DEFAULT_VFOV_DEGREES,
        near: float = DEFAULT_NEAR,
        far: float = DEFAULT_FAR,
        depth_iterations: int = DEFAULT_DEPTH_ITERATIONS,
        backend: str = "auto",
    ):
        """backend: 'fused' = the GPU kernels (rays generated in-kernel, RGB
        as the only full-frame write), 'interpret' = the same kernels in the
        Pallas interpreter, 'jnp' = pure-jnp path, 'auto' = the rule in
        render.pallas.raymarch_kernel.resolve_backend."""
        from sdfkit.render.pallas.raymarch_kernel import resolve_backend

        self.backend = resolve_backend(backend, sdf)
        self.sdf = sdf
        self.view = default_view() if view is None else jnp.asarray(view, jnp.float32)
        self.config = RenderConfig(
            width=width,
            height=height,
            vfov_degrees=float(vfov_degrees),
            near=float(near),
            far=float(far),
            depth_iterations=int(depth_iterations),
        )

    def _view(self, camera):
        if camera is None:
            return self.view
        return jnp.asarray(camera, jnp.float32)

    def _fused(self, camera, depth_only: bool) -> Array:
        return _render_fused(self.sdf, self._view(camera), self.config,
                             self.backend == "interpret", depth_only)

    def render(self, camera=None) -> Array:
        if self.backend != "jnp":
            return self._fused(camera, depth_only=False)
        return _render_impl(self.sdf, self._view(camera), self.config)

    def render_depth(self, camera=None) -> Array:
        if self.backend != "jnp":
            return self._fused(camera, depth_only=True)
        return _render_depth_impl(self.sdf, self._view(camera), self.config)


def render(
    sdf: SdfExpr,
    width: int,
    height: int,
    camera_position=None,
    camera_target=(0.0, 0.0, 0.0),
    camera_up=(0.0, 1.0, 0.0),
    view=None,
    **kwargs,
) -> Array:
    """Functional entry point mirroring ``Sdf.ToImage`` (Sdf.cs:65-99)."""
    if view is None:
        if camera_position is None:
            view = default_view()
        else:
            view = look_at(camera_position, camera_target, camera_up)
    return RayMarcher(width, height, sdf, view=view, **kwargs).render()


def render_depth(sdf: SdfExpr, width: int, height: int, view=None, **kwargs) -> Array:
    if view is None:
        view = default_view()
    return RayMarcher(width, height, sdf, view=view, **kwargs).render_depth()
