"""Ray marcher tests — golden depth values from the reference
(Tests/RayMarcherTests.cs): 50x30 images, camera at (0,0,5) looking at origin.
"""

import jax
import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from sdfkit.utils.v3 import V3

W, H = 50, 30


def depth_at(img, x, y):
    """Reference indexer img[x, y] is column-major (x=width index)."""
    return float(img[y, x])


class TestRenderDepth:
    def test_sphere_depth(self):
        # RayMarcherTests.SphereDepth: center 4.0 +/- 1e-2, corner > 9 (miss).
        img = np.asarray(sk.render_depth(sk.sphere(1.0), W, H))
        assert img.shape == (H, W)
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2
        assert depth_at(img, 0, 0) > 9.0

    def test_box_depth(self):
        img = np.asarray(sk.render_depth(sk.box(1.0), W, H))
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2
        assert depth_at(img, 0, 0) > 9.0

    def test_plane_depth(self):
        # PlaneDepth: center 5.0 +/- 1e-2, corner < 9 (hit).
        img = np.asarray(sk.render_depth(sk.plane_xy(), W, H))
        assert abs(depth_at(img, W // 2, H // 2) - 5.0) < 1e-2
        assert depth_at(img, 0, 0) < 9.0

    def test_cylinder_repeat_depth(self):
        # CylinderDepth: repeated cylinder, pixel above center ~= 5 - r.
        r = 0.25
        s = sk.cylinder(r, r * 2).repeat_x(4 * r)
        img = np.asarray(sk.render_depth(s, W, H))
        assert abs(depth_at(img, W // 2, H // 2 - 2) - (5 - r)) < 1e-1
        assert depth_at(img, 0, 0) > 9.0


class TestRender:
    def test_sphere_rgb_shading(self):
        img = np.asarray(sk.render(sk.sphere(1.0), W, H))
        assert img.shape == (H, W, 3)
        # Corners are sky.
        np.testing.assert_allclose(img[0, 0], [0.5, 0.75, 1.0], atol=1e-5)
        # Center pixel is lit white-ish (diffuse white + ambient), not sky.
        c = img[H // 2, W // 2]
        assert c[0] == c[1] == c[2]
        assert 0.1 < c[0] <= 1.2
        # Light at (5,5,10): upper-right of the sphere is brighter than lower-left.
        assert img[H // 2 - 3, W // 2 + 3, 0] > img[H // 2 + 3, W // 2 - 3, 0]

    def test_colored_render(self):
        img = np.asarray(sk.render(sk.sphere(1.0, color=(1.0, 0.0, 0.0)), W, H))
        c = img[H // 2, W // 2]
        assert c[0] > 0.5
        # Green/blue get only ambient.
        np.testing.assert_allclose(c[1], 0.1, atol=1e-5)
        np.testing.assert_allclose(c[2], 0.1, atol=1e-5)

    def test_sphere_repeat_scene(self):
        # The README/Perf hero scene at small scale (Perf/Program.cs:5-22).
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
        img = np.asarray(
            sk.render(s, 96, 54, camera_position=(-2, 2, 4))
        )
        assert img.shape == (54, 96, 3)
        assert np.isfinite(img).all()
        # Scene fills the frame with spheres: no sky anywhere near center rows.
        assert img[:, :, 2].std() > 0.01

    def test_camera_look_at(self):
        # Camera from +x side: sphere at origin still centered, depth ~4.
        img = np.asarray(
            sk.render_depth(
                sk.sphere(1.0),
                W,
                H,
                view=sk.look_at((5, 0, 0), (0, 0, 0), (0, 1, 0)),
            )
        )
        assert abs(depth_at(img, W // 2, H // 2) - 4.0) < 1e-2

    def test_depth_iterations_override(self):
        img = np.asarray(
            sk.RayMarcher(W, H, sk.sphere(1.0), depth_iterations=5).render_depth()
        )
        # 5 iterations from depth 0.9 cannot converge fully but moves toward 4.
        assert 2.0 < depth_at(img, W // 2, H // 2) < 4.05


class TestDifferentiability:
    def test_smooth_union_grads_match_finite_difference(self):
        # BASELINE.md config 4: grads of an image loss wrt the smooth-union
        # blend k and a shape radius, checked against central differences.
        def loss(k, r):
            s = sk.sphere(r, color=(0.9, 0.3, 0.2)).smooth_union(
                sk.box(0.6, color=(0.2, 0.5, 0.9)).translate(0.9, 0, 0), k
            )
            return jnp.mean(sk.RayMarcher(24, 16, s).render() ** 2)

        k0, r0 = jnp.float32(0.3), jnp.float32(0.8)
        gk, gr = jax.grad(loss, argnums=(0, 1))(k0, r0)
        e = 1e-2
        fdk = (loss(k0 + e, r0) - loss(k0 - e, r0)) / (2 * e)
        fdr = (loss(k0, r0 + e) - loss(k0, r0 - e)) / (2 * e)
        # Silhouette pixels make image losses only piecewise-smooth; interior
        # contributions dominate at this scene scale.
        np.testing.assert_allclose(float(gk), float(fdk), rtol=0.15, atol=5e-4)
        np.testing.assert_allclose(float(gr), float(fdr), rtol=0.15, atol=5e-4)

    def test_grad_of_depth_wrt_radius(self):
        # d(depth)/d(radius) at the center pixel is ~-1 (sphere surface moves
        # toward the camera as the radius grows).
        def center_depth(r):
            s = sk.Sphere(r, jnp.ones(3))
            img = sk.render_depth(s, 9, 9)
            return img[4, 4]

        g = jax.grad(center_depth)(jnp.float32(1.0))
        np.testing.assert_allclose(float(g), -1.0, atol=1e-2)

    def test_grad_of_image_loss_wrt_params(self):
        def loss(params):
            r, color = params
            s = sk.Sphere(r, color)
            img = sk.render(s, 16, 16)
            return jnp.mean(img**2)

        params = (jnp.float32(1.0), jnp.array([0.8, 0.2, 0.4], jnp.float32))
        g = jax.grad(loss)(params)
        assert np.isfinite(float(g[0]))
        assert np.isfinite(np.asarray(g[1])).all()
        assert float(jnp.abs(g[1]).sum()) > 0
