"""Camera matrices with System.Numerics semantics.

The reference builds its view/projection with ``Matrix4x4.CreateLookAt`` and
``Matrix4x4.CreatePerspectiveFieldOfView`` and multiplies **row vectors**
(`v' = v @ M`), right-handed (reference: RayMarcher.cs:95-126, Sdf.cs:84-99).
We reproduce those exact matrix layouts so depth/pixel goldens transfer.
"""

from __future__ import annotations

import jax.numpy as jnp

from sdfkit.utils.v3 import V3


def _f32(v):
    return jnp.asarray(v, dtype=jnp.float32)


def _dot(a, b):
    # Full float32 precision: on a GPU a default-precision product may run in
    # TF32, and ray directions feed a 40-step march that amplifies rounding.
    return jnp.dot(a, b, precision="highest")


def look_at(camera_position, camera_target, camera_up) -> jnp.ndarray:
    """Row-vector view matrix, right-handed (System.Numerics CreateLookAt)."""
    pos = _f32(camera_position)
    target = _f32(camera_target)
    up = _f32(camera_up)
    zaxis = pos - target
    zaxis = zaxis / jnp.linalg.norm(zaxis)
    xaxis = jnp.cross(up, zaxis)
    xaxis = xaxis / jnp.linalg.norm(xaxis)
    yaxis = jnp.cross(zaxis, xaxis)
    m = jnp.stack(
        [
            jnp.array([xaxis[0], yaxis[0], zaxis[0], 0.0], dtype=jnp.float32),
            jnp.array([xaxis[1], yaxis[1], zaxis[1], 0.0], dtype=jnp.float32),
            jnp.array([xaxis[2], yaxis[2], zaxis[2], 0.0], dtype=jnp.float32),
            jnp.concatenate(
                [
                    -jnp.stack([_dot(xaxis, pos), _dot(yaxis, pos),
                                _dot(zaxis, pos)]),
                    jnp.ones((1,), dtype=jnp.float32),
                ]
            ),
        ]
    )
    return m


def perspective_fov(vfov_radians, aspect, near, far) -> jnp.ndarray:
    """Row-vector perspective matrix (System.Numerics
    CreatePerspectiveFieldOfView)."""
    y_scale = 1.0 / jnp.tan(_f32(vfov_radians) * 0.5)
    x_scale = y_scale / _f32(aspect)
    neg_far_range = _f32(far) / (_f32(near) - _f32(far))
    zero = jnp.zeros(())
    one = jnp.ones(())
    return jnp.stack(
        [
            jnp.stack([x_scale, zero, zero, zero]),
            jnp.stack([zero, y_scale, zero, zero]),
            jnp.stack([zero, zero, neg_far_range, -one]),
            jnp.stack([zero, zero, _f32(near) * neg_far_range, zero]),
        ]
    ).astype(jnp.float32)


def camera_rays(
    width: int,
    height: int,
    view: jnp.ndarray,
    vfov_degrees=60.0,
    near=1.0,
    far=100.0,
) -> tuple[V3, V3]:
    """Per-pixel ray origins and directions, row 0 = top of image.

    Unprojects NDC points (x, y, 0, 1) through inverse(view @ proj) exactly as
    the reference does (RayMarcher.GetCameraRays, RayMarcher.cs:95-126):
    NDC range uses /(width-1), /(height-1); y is flipped.
    """
    cam_tf = jnp.linalg.inv(view)
    cam_pos = cam_tf[3, :3]  # (0,0,0,1) @ inv(view)

    proj = perspective_fov(
        jnp.deg2rad(_f32(vfov_degrees)), width / height, near, far
    )
    inv_vp = jnp.linalg.inv(_dot(view, proj))

    # Pixel grid in NDC. Guard the width/height==1 degenerate case.
    wden = max(width - 1, 1)
    hden = max(height - 1, 1)
    xs = -1.0 + 2.0 * jnp.arange(width, dtype=jnp.float32) / wden
    ys = 1.0 - 2.0 * jnp.arange(height, dtype=jnp.float32) / hden
    x = jnp.broadcast_to(xs[None, :], (height, width))
    y = jnp.broadcast_to(ys[:, None], (height, width))

    # (x, y, 0, 1) @ inv_vp, written out to keep structure-of-arrays layout.
    hx = x * inv_vp[0, 0] + y * inv_vp[1, 0] + inv_vp[3, 0]
    hy = x * inv_vp[0, 1] + y * inv_vp[1, 1] + inv_vp[3, 1]
    hz = x * inv_vp[0, 2] + y * inv_vp[1, 2] + inv_vp[3, 2]
    hw = x * inv_vp[0, 3] + y * inv_vp[1, 3] + inv_vp[3, 3]

    pos = V3(hx / hw, hy / hw, hz / hw)
    ro = V3(
        jnp.broadcast_to(cam_pos[0], (height, width)),
        jnp.broadcast_to(cam_pos[1], (height, width)),
        jnp.broadcast_to(cam_pos[2], (height, width)),
    )
    rd = (pos - ro).normalize()
    return ro, rd


DEFAULT_VIEW_EYE = (0.0, 0.0, 5.0)


def default_view() -> jnp.ndarray:
    """Reference default: look-at from (0,0,5) to origin, +Y up
    (RayMarcher.cs:22-23)."""
    return look_at(DEFAULT_VIEW_EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
