"""Fused sphere-trace kernel parity tests (the Triton-route kernels run in
the Pallas interpreter on CPU: backend='interpret').

The fused kernel must match the jnp reference path: depth to within the fp
drift of two separately-compiled 40-step marches (XLA's shape-dependent FMA
contraction rounds ``ro + rd*depth`` differently per computation, and the
march compounds the ulps — relative, since miss rays accumulate ~1e6 depths),
RGB within silhouette-pixel normalize noise, and gradients finite and
consistent.
"""

import jax
import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from sdfkit.utils.v3 import V3

W, H = 40, 24


def scene():
    return sk.sphere(1.0, color=(0.9, 0.4, 0.2)).repeat_xy(2.5, 2.5)


class TestFusedParity:
    def test_depth_exact(self):
        s = scene()
        dj = np.asarray(sk.RayMarcher(W, H, s, backend="jnp").render_depth())
        df = np.asarray(sk.RayMarcher(W, H, s, backend="interpret").render_depth())
        np.testing.assert_allclose(dj, df, rtol=1e-4)

    def test_rgb_close(self):
        s = scene()
        ij = np.asarray(sk.RayMarcher(W, H, s, backend="jnp").render())
        iff = np.asarray(sk.RayMarcher(W, H, s, backend="interpret").render())
        # Hit pixels match to fp noise; silhouette pixels may differ slightly
        # through the normalize amplification.
        assert np.abs(ij - iff).max() < 2e-2
        assert np.median(np.abs(ij - iff)) < 1e-6

    def test_non_tile_aligned_sizes(self):
        # 17x13 = 221 rays exercises the padding path.
        s = scene()
        dj = np.asarray(sk.RayMarcher(17, 13, s, backend="jnp").render_depth())
        df = np.asarray(sk.RayMarcher(17, 13, s, backend="interpret").render_depth())
        np.testing.assert_allclose(dj, df, rtol=1e-4)

    def test_scene_with_cell_colors(self):
        r = 0.5
        s = sk.sphere(r).repeat_xy(
            2.25 * r,
            2.25 * r,
            lambda i, p, c, d: V3(
                0.9 - jnp.abs(i.x) / 6.0,
                0.9 - jnp.abs(i.y) / 6.0,
                jnp.full_like(i.z, 0.9),
            ),
        )
        ij = np.asarray(sk.RayMarcher(W, H, s, backend="jnp").render())
        iff = np.asarray(sk.RayMarcher(W, H, s, backend="interpret").render())
        assert np.median(np.abs(ij - iff)) < 1e-6


def _union_tree(n: int):
    """Balanced union of n translated spheres: n x (radius + rgb + 3
    offsets) scalars at O(log n) tree depth — the fitted-CSG shape class."""
    prims = [sk.sphere(1.0).translate(float(i), 0.0, 0.0) for i in range(n)]
    while len(prims) > 1:
        paired = [a | b for a, b in zip(prims[::2], prims[1::2])]
        prims = paired + (prims[-1:] if len(prims) % 2 else [])
    return prims[0]


class TestFusedParamCap:
    def test_union_tree_matches_jnp(self):
        # A multi-leaf tree: every leaf is packed into one parameter vector
        # and rebuilt from scalar loads in the kernel (ScalarArray leaves).
        s = _union_tree(3)
        dj = np.asarray(sk.RayMarcher(16, 8, s, backend="jnp").render_depth())
        df = np.asarray(
            sk.RayMarcher(16, 8, s, backend="interpret").render_depth()
        )
        np.testing.assert_allclose(dj, df, rtol=1e-4)
        ij = np.asarray(sk.RayMarcher(16, 8, s, backend="jnp").render())
        iff = np.asarray(sk.RayMarcher(16, 8, s, backend="interpret").render())
        assert np.median(np.abs(ij - iff)) < 1e-6

    def test_union_tree_grads_match(self):
        # jax.grad through both kernels for a multi-leaf tree: every leaf's
        # cotangent comes back from its slot of the per-program partials.
        # Depth loss: no finite-difference normals, so the two programs
        # agree to reduction-order rounding.
        from sdfkit.render.pallas import raymarch_kernel as rk
        from sdfkit.render.raymarch import RenderConfig, render_depth_rays
        from sdfkit.utils.camera import camera_rays

        s = _union_tree(3)
        cfg = RenderConfig(width=16, height=8)
        view = sk.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))

        def masked(d):
            return jnp.sum(jnp.where(d < 50.0, d, 0.0))

        def loss_fused(s):
            return masked(rk.render_depth_image_fused(s, view, cfg, True))

        def loss_jnp(s):
            ro, rd = camera_rays(16, 8, view, cfg.vfov_degrees, cfg.near,
                                 cfg.far)
            return masked(render_depth_rays(s, ro, rd, cfg))

        for a, b in zip(
            jax.tree_util.tree_leaves(jax.grad(loss_fused)(s)),
            jax.tree_util.tree_leaves(jax.grad(loss_jnp)(s)),
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=2e-3, atol=1e-4
            )

    def test_oversized_tree_raises_with_jnp_hint(self):
        # Past MAX_FUSED_PARAM_SCALARS the kernels refuse (register spills
        # and compile time); the error must point at backend='jnp'.
        import pytest

        from sdfkit.render.pallas import raymarch_kernel as rk

        s = _union_tree((rk.MAX_FUSED_PARAM_SCALARS // 7) + 2)
        with pytest.raises(ValueError, match="backend='jnp'"):
            sk.RayMarcher(8, 8, s, backend="interpret").render_depth()
        # The jnp backend accepts the same tree (tiny frame + 2 iterations:
        # tracing a large tree through a full march is pure test overhead).
        d = np.asarray(
            sk.RayMarcher(4, 4, s, backend="jnp", depth_iterations=2)
            .render_depth()
        )
        assert np.all(np.isfinite(d))


class TestFusedGradients:
    def test_grad_finite_and_close_to_jnp(self):
        def loss(r, backend):
            s = sk.Sphere(r, jnp.ones(3))
            return jnp.mean(sk.RayMarcher(16, 16, s, backend=backend).render() ** 2)

        gj = float(jax.grad(loss)(jnp.float32(1.0), "jnp"))
        gf = float(jax.grad(loss)(jnp.float32(1.0), "interpret"))
        assert np.isfinite(gj) and np.isfinite(gf)
        assert abs(gj - gf) < 0.05 * max(abs(gj), 1e-3) + 1e-2

    def test_view_grad_matches_jnp(self):
        # The image-level fused kernel generates rays in-kernel from the
        # view matrix; its custom VJP must route gradients back to the view
        # identically to the jnp path.
        s = scene()
        view = sk.look_at((0.3, 0.2, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))

        def loss(v, backend):
            m = sk.RayMarcher(16, 16, s, backend=backend)
            return jnp.mean(m.render(camera=v) ** 2)

        gj = np.asarray(jax.grad(loss)(view, "jnp"))
        gf = np.asarray(jax.grad(loss)(view, "interpret"))
        assert np.all(np.isfinite(gf))
        np.testing.assert_allclose(gj, gf, rtol=5e-2, atol=1e-3)

    def test_color_grad_matches_finite_difference(self):
        # Color parameters act smoothly (no silhouette discontinuity), so
        # autodiff must match finite differences tightly.
        def loss(c):
            s = sk.Sphere(jnp.float32(1.0), jnp.array([c, 0.3, 0.3]))
            return jnp.mean(sk.RayMarcher(16, 16, s, backend="interpret").render() ** 2)

        g = float(jax.grad(loss)(jnp.float32(0.8)))
        e = 1e-2
        fd = (loss(jnp.float32(0.8 + e)) - loss(jnp.float32(0.8 - e))) / (2 * e)
        np.testing.assert_allclose(g, float(fd), rtol=1e-2)

    def test_all_leaf_grads_match_jnp_color_and_depth(self):
        # The backward kernel (march replay + reverse sweep) must match jnp
        # autodiff for EVERY pytree leaf of a multi-primitive scene, through
        # both the RGB and the depth outputs, at a non-block-aligned size.
        # rtol covers f32 reduction-order drift between the per-program
        # partial sums and XLA's reduction tree.
        from sdfkit.render.raymarch import RenderConfig, render_rays
        from sdfkit.render.raymarch import render_depth_rays
        from sdfkit.render.pallas.raymarch_kernel import (
            render_depth_image_fused,
            render_image_fused,
        )
        from sdfkit.utils.camera import camera_rays

        s = sk.sphere(0.8, color=(0.9, 0.4, 0.2)) | sk.box(0.4).translate(
            1.0, 0.0, 0.0
        )
        view = sk.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        cfg = RenderConfig(width=24, height=16)

        def loss_fused(s, v):
            return jnp.sum(render_image_fused(s, v, cfg, True) ** 2)

        def loss_jnp(s, v):
            ro, rd = camera_rays(
                cfg.width, cfg.height, v, cfg.vfov_degrees, cfg.near, cfg.far
            )
            return jnp.sum(render_rays(s, ro, rd, cfg) ** 2)

        def check(gf, gj):
            # SDF parameter grads: tight. View-matrix grads: looser — the
            # march amplifies ulp-level linearization-point differences near
            # silhouettes by ~(1 + grad.rd) per step, and the view grad sums
            # 39 such steps per pixel.
            for a, b in zip(
                jax.tree_util.tree_leaves(gf[0]),
                jax.tree_util.tree_leaves(gj[0]),
            ):
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=2e-3, atol=1e-5
                )
            np.testing.assert_allclose(
                np.asarray(gf[1]), np.asarray(gj[1]), rtol=5e-2, atol=1e-3
            )

        check(
            jax.grad(loss_fused, argnums=(0, 1))(s, view),
            jax.grad(loss_jnp, argnums=(0, 1))(s, view),
        )

        def dloss_fused(s, v):
            d = render_depth_image_fused(s, v, cfg, True)
            return jnp.sum(jnp.where(d < 50.0, d, 0.0) ** 2)

        def dloss_jnp(s, v):
            ro, rd = camera_rays(
                cfg.width, cfg.height, v, cfg.vfov_degrees, cfg.near, cfg.far
            )
            d = render_depth_rays(s, ro, rd, cfg)
            return jnp.sum(jnp.where(d < 50.0, d, 0.0) ** 2)

        check(
            jax.grad(dloss_fused, argnums=(0, 1))(s, view),
            jax.grad(dloss_jnp, argnums=(0, 1))(s, view),
        )


class TestIndexedPaletteFused:
    def test_indexed_palette_scene_matches_jnp(self):
        # The (T, 3) palette leaf rides the kernel's param flattening; the
        # one-hot blend must vectorize identically in both backends.
        import jax.numpy as jnp

        table = jnp.asarray(
            [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]]
        )
        s = sk.sphere(0.5).repeat_indexed("xy", (1.125, 1.125), table)
        ij = np.asarray(sk.RayMarcher(W, H, s, backend="jnp").render())
        iff = np.asarray(sk.RayMarcher(W, H, s, backend="interpret").render())
        assert np.median(np.abs(ij - iff)) < 1e-6
