"""SDF expression DSL tests: primitive math, CSG, modifiers, differentiability.

Golden formulas from the reference: exact box SDF (Sdf.cs:125-139), cylinder
(SdfExpr.cs:28-32), floor-mod repetition (SdfExpr.cs:149-201,
VectorData.cs:697-698), union picks smaller W (SdfExpr.cs:54-68).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdfkit as sk
from sdfkit.utils.v3 import V3, vmod


def eval_at(expr, points):
    out = np.asarray(expr(jnp.asarray(points, jnp.float32)))
    return out


class TestPrimitives:
    def test_sphere_distance(self):
        s = sk.sphere(0.5)
        out = eval_at(s, [[0, 0, 0], [1, 0, 0], [0, 2, 0]])
        np.testing.assert_allclose(out[:, 3], [-0.5, 0.5, 1.5], atol=1e-6)
        np.testing.assert_allclose(out[:, :3], 1.0)

    def test_sphere_color(self):
        s = sk.sphere(1.0, color=(0.2, 0.4, 0.6))
        out = eval_at(s, [[0, 0, 0]])
        np.testing.assert_allclose(out[0, :3], [0.2, 0.4, 0.6], atol=1e-6)

    def test_box_outside_corner(self):
        b = sk.box(1.0)
        # Distance from (2,2,2) to corner (1,1,1) is sqrt(3).
        out = eval_at(b, [[2, 2, 2]])
        np.testing.assert_allclose(out[0, 3], np.sqrt(3), rtol=1e-6)

    def test_box_face_and_inside(self):
        b = sk.box((1.0, 2.0, 3.0))
        out = eval_at(b, [[1.5, 0, 0], [0, 0, 0], [0.5, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [0.5, -1.0, -0.5], atol=1e-6)

    def test_cylinder(self):
        c = sk.cylinder(1.0, 2.0)
        out = eval_at(c, [[2, 0, 0], [0, 3, 0], [0, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [1.0, 1.0, -1.0], atol=1e-6)

    def test_plane(self):
        p = sk.plane_xy()
        out = eval_at(p, [[0, 0, 2], [5, 7, -3]])
        np.testing.assert_allclose(out[:, 3], [2.0, -3.0], atol=1e-6)
        p2 = sk.plane_xz(1.0)
        out = eval_at(p2, [[0, 2, 0]])
        np.testing.assert_allclose(out[0, 3], 3.0, atol=1e-6)

    def test_solid_wraps_distance_fn(self):
        s = sk.solid(lambda p: p.length() - 2.0, color=(1, 0, 0))
        out = eval_at(s, [[3, 0, 0]])
        np.testing.assert_allclose(out[0, 3], 1.0, atol=1e-6)
        np.testing.assert_allclose(out[0, :3], [1, 0, 0])

    def test_torus(self):
        t = sk.torus(2.0, 0.5)
        out = eval_at(t, [[2, 0, 0], [0, 0, 2.5]])
        np.testing.assert_allclose(out[:, 3], [-0.5, 0.0], atol=1e-6)

    def test_capsule(self):
        c = sk.capsule((0, -1, 0), (0, 1, 0), 0.5)
        out = eval_at(c, [[0, 0, 0], [0, 2, 0], [1, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [-0.5, 0.5, 0.5], atol=1e-6)


class TestCsg:
    def test_union_picks_smaller_distance_and_its_color(self):
        a = sk.sphere(1.0, color=(1, 0, 0)).translate(-1, 0, 0)
        b = sk.sphere(1.0, color=(0, 1, 0)).translate(1, 0, 0)
        u = a | b
        out = eval_at(u, [[-1.5, 0, 0], [1.5, 0, 0]])
        np.testing.assert_allclose(out[0, :3], [1, 0, 0])
        np.testing.assert_allclose(out[1, :3], [0, 1, 0])
        np.testing.assert_allclose(out[:, 3], [-0.5, -0.5], atol=1e-6)

    def test_union_variadic(self):
        u = sk.union(sk.sphere(1.0), sk.box(0.5), sk.plane_xy(5.0))
        out = eval_at(u, [[0, 0, -10]])
        np.testing.assert_allclose(out[0, 3], -5.0, atol=1e-6)

    def test_intersection_subtraction(self):
        a = sk.sphere(1.0)
        b = sk.plane_xy()  # keeps z < 0 inside
        i = a & b
        out = eval_at(i, [[0, 0, 0.5], [0, 0, -0.5]])
        np.testing.assert_allclose(out[:, 3], [0.5, -0.5], atol=1e-6)
        s = a.subtract(sk.sphere(0.5))
        out = eval_at(s, [[0, 0, 0], [0.75, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [0.5, -0.25], atol=1e-6)

    def test_smooth_union_bounds_and_blend(self):
        a = sk.sphere(1.0, color=(1, 0, 0)).translate(-1, 0, 0)
        b = sk.sphere(1.0, color=(0, 0, 1)).translate(1, 0, 0)
        u = a.smooth_union(b, 0.25)
        hard = eval_at(a | b, [[0, 0.5, 0]])
        smooth = eval_at(u, [[0, 0.5, 0]])
        # Smooth union is <= hard union, and blends colors at the midpoint.
        assert smooth[0, 3] <= hard[0, 3] + 1e-6
        assert 0.2 < smooth[0, 0] < 0.8  # red channel blended

    def test_smooth_union_far_matches_hard(self):
        a = sk.sphere(1.0).translate(-5, 0, 0)
        b = sk.sphere(1.0).translate(5, 0, 0)
        u = a.smooth_union(b, 0.1)
        h = a | b
        pts = [[-5, 0, 0], [5.5, 0, 0]]
        np.testing.assert_allclose(
            eval_at(u, pts)[:, 3], eval_at(h, pts)[:, 3], atol=1e-5
        )


class TestModifiers:
    def test_translate(self):
        s = sk.sphere(1.0).translate(2, 0, 0)
        out = eval_at(s, [[2, 0, 0], [0, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [-1.0, 1.0], atol=1e-6)

    def test_scale(self):
        s = sk.sphere(1.0).scale(2.0)
        out = eval_at(s, [[4, 0, 0], [0, 0, 0]])
        np.testing.assert_allclose(out[:, 3], [2.0, -2.0], atol=1e-6)

    def test_color_override(self):
        s = sk.sphere(1.0).color(0.95, 0.95, 0.0)
        out = eval_at(s, [[0, 0, 0]])
        np.testing.assert_allclose(out[0, :3], [0.95, 0.95, 0.0], atol=1e-6)
        np.testing.assert_allclose(out[0, 3], -1.0, atol=1e-6)

    def test_vmod_matches_reference_floor_mod(self):
        a = jnp.array([-1.25, -0.5, 0.5, 2.75], jnp.float32)
        out = np.asarray(vmod(a, jnp.float32(1.0)))
        np.testing.assert_allclose(out, [0.75, 0.5, 0.5, 0.75], atol=1e-6)

    def test_repeat_x_period(self):
        s = sk.sphere(0.25).repeat_x(1.0)
        pts = [[0, 0, 0], [1, 0, 0], [-3, 0, 0], [0.5, 0, 0]]
        out = eval_at(s, pts)
        np.testing.assert_allclose(out[0, 3], out[1, 3], atol=1e-6)
        np.testing.assert_allclose(out[0, 3], out[2, 3], atol=1e-6)
        np.testing.assert_allclose(out[3, 3], 0.25, atol=1e-6)  # cell corner

    def test_repeat_xy_with_cell_color(self):
        # SphereRepeat scene coloring: 0.9 - |i|/6 (Perf/Program.cs:5-22).
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
        out = eval_at(s, [[0, 0, 0], [2.25 * r, 0, 0]])
        np.testing.assert_allclose(out[0, :3], [0.9, 0.9, 0.9], atol=1e-6)
        np.testing.assert_allclose(out[1, :3], [0.9 - 1 / 6, 0.9, 0.9], atol=1e-6)
        np.testing.assert_allclose(out[0, 3], out[1, 3], atol=1e-6)

    def test_repeat_xz(self):
        b = sk.box(0.25).repeat_xz(2.0, 2.0)
        out = eval_at(b, [[2, 0, 2], [0, 0, 0]])
        np.testing.assert_allclose(out[0, 3], out[1, 3], atol=1e-6)

    def test_rotate_preserves_distance(self):
        import jax

        s = sk.box((1.0, 0.2, 0.2)).rotate_z(jnp.pi / 2)
        # Long axis now points along y: (0, 0.9, 0) is inside, (0.9, 0, 0) out.
        p = jnp.array([[0.0, 0.9, 0.0], [0.9, 0.0, 0.0]], jnp.float32)
        d = np.asarray(s(p))[:, 3]
        assert d[0] < 0 < d[1]
        # Differentiable pose: gradient of distance wrt angle is finite.
        g = jax.grad(
            lambda a: jnp.sum(
                sk.box((1.0, 0.2, 0.2)).rotate_y(a)(p)[:, 3]
            )
        )(jnp.float32(0.3))
        assert np.isfinite(float(g))

    def test_round_and_shell(self):
        def dist1(expr, p):
            return float(eval_at(expr, [list(p)])[0, 3])

        s = sk.sphere(1.0).round(0.25)  # sphere of effective radius 1.25
        assert abs(dist1(s, (1.25, 0, 0))) < 1e-6
        sh = sk.sphere(1.0).shell(0.2)  # hollow: surfaces at r=0.9 and 1.1
        assert abs(dist1(sh, (1.1, 0, 0))) < 1e-6
        assert abs(dist1(sh, (0.9, 0, 0))) < 1e-6
        assert dist1(sh, (1.0, 0, 0)) < 0

    def test_modify_input(self):
        # Shear warp: evaluate sphere at p - (y, 0, 0).
        s = sk.sphere(1.0).modify_input(lambda p: V3(p.x - p.y, p.y, p.z))
        out = eval_at(s, [[1, 1, 0]])
        np.testing.assert_allclose(out[0, 3], 0.0, atol=1e-6)

    def test_modify_output(self):
        s = sk.sphere(1.0).modify_output(
            lambda p, c, d: V3(jnp.abs(p.x), c.y * 0.5, jnp.zeros_like(d))
        )
        out = eval_at(s, [[-2, 0, 0]])
        np.testing.assert_allclose(out[0, :3], [2.0, 0.5, 0.0], atol=1e-6)


class TestTraceability:
    def test_jit_and_batch_shapes(self):
        s = sk.sphere(1.0).repeat_xy(2.0, 2.0)
        f = s.to_sdf()
        out = f(jnp.zeros((7, 5, 3)))
        assert out.shape == (7, 5, 4)

    def test_grad_wrt_radius(self):
        def loss(r):
            s = sk.Sphere(r, jnp.ones(3))
            return s(jnp.array([[2.0, 0, 0]]))[0, 3]

        g = jax.grad(loss)(jnp.float32(0.5))
        np.testing.assert_allclose(g, -1.0, atol=1e-6)

    def test_grad_through_csg_tree(self):
        def loss(params):
            r, off, k = params
            a = sk.Sphere(r, jnp.ones(3)).translate(off, 0.0, 0.0)
            b = sk.box(0.5)
            u = a.smooth_union(b, k)
            pts = jnp.array([[1.0, 0.5, 0.25], [0.1, -0.2, 0.9]])
            return jnp.sum(u(pts)[:, 3])

        params = (jnp.float32(0.7), jnp.float32(0.3), jnp.float32(0.2))
        g = jax.grad(loss)(params)
        assert all(np.isfinite(np.asarray(gi)).all() for gi in g)
        # Finite-difference check on the radius.
        eps = 1e-3
        f0 = loss((params[0] - eps, params[1], params[2]))
        f1 = loss((params[0] + eps, params[1], params[2]))
        np.testing.assert_allclose(g[0], (f1 - f0) / (2 * eps), atol=1e-2)

    def test_expr_is_pytree(self):
        s = sk.sphere(1.0).translate(1, 2, 3) | sk.box(0.5)
        leaves = jax.tree_util.tree_leaves(s)
        assert len(leaves) > 0
        s2 = jax.tree_util.tree_map(lambda x: x, s)
        out1 = eval_at(s, [[0.3, 0.4, 0.5]])
        out2 = eval_at(s2, [[0.3, 0.4, 0.5]])
        np.testing.assert_array_equal(out1, out2)


class TestRepeatIndexedColor:
    """Differentiable per-cell palette (RepeatIndexedColor): the trainable
    analogue of the reference's SdfIndexedOutputModifierFunc color hooks
    (SdfExpr.cs:163-178)."""

    def _palette(self):
        return jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])

    def test_cell_colors_follow_table_with_floor_mod(self):
        s = sk.sphere(0.3).repeat_indexed("x", (1.0,), self._palette())
        pts = jnp.asarray(
            [[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [-1.0, 0, 0]]
        )
        out = np.asarray(s(pts))
        np.testing.assert_allclose(out[0, :3], [1, 0, 0])
        np.testing.assert_allclose(out[1, :3], [0, 1, 0])
        np.testing.assert_allclose(out[2, :3], [1, 0, 0])  # wraps mod T
        np.testing.assert_allclose(out[3, :3], [0, 1, 0])  # negative cell
        # Distances are untouched by the color machinery.
        np.testing.assert_allclose(out[:, 3], -0.3, atol=1e-6)

    def test_matches_color_fn_repeat(self):
        # Same scene through the static color_fn path: colors must agree.
        table = self._palette()
        s_ix = sk.sphere(0.4).repeat_indexed("xy", (1.0, 1.0), table)
        from sdfkit.utils.v3 import V3

        def color_fn(i, p, c, d):
            pos = i.x + i.y
            pos = pos - jnp.floor(pos / 2.0) * 2.0
            w = (pos == 0).astype(jnp.float32)
            return V3(w * 1.0, (1.0 - w) * 1.0, jnp.zeros_like(w))

        s_fn = sk.sphere(0.4).repeat_xy(1.0, 1.0, color_fn)
        pts = (np.random.default_rng(3).random((64, 3)) * 6 - 3).astype(
            np.float32
        )
        np.testing.assert_allclose(
            np.asarray(s_ix(pts)), np.asarray(s_fn(pts)), atol=1e-6
        )

    def test_custom_index_fn_and_multiply(self):
        table = jnp.asarray([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
        s = sk.sphere(0.3, color=(0.8, 0.4, 0.2)).repeat_indexed(
            "x", (1.0,), table,
            index_fn=lambda ix, iy, iz: ix * 3.0,  # 3 mod 2 = 1 at cell 1
            combine="multiply",
        )
        out = np.asarray(s(jnp.asarray([[0.0, 0, 0], [1.0, 0, 0]])))
        np.testing.assert_allclose(out[0, :3], [0.4, 0.2, 0.1], atol=1e-6)
        np.testing.assert_allclose(out[1, :3], [0.8, 0.4, 0.2], atol=1e-6)

    def test_table_is_a_data_leaf_with_gradient(self):
        table = self._palette()
        s = sk.sphere(0.3).repeat_indexed("x", (1.0,), table)
        leaves = jax.tree_util.tree_leaves(s)
        assert any(np.shape(l) == (2, 3) for l in leaves)

        def loss(sdf):
            pts = jnp.asarray([[0.0, 0, 0], [1.0, 0, 0]])
            return jnp.sum((sdf(pts)[:, :3] - 0.25) ** 2)

        g = jax.grad(loss)(s)
        gt = np.asarray(g.table)
        assert gt.shape == (2, 3) and np.abs(gt).sum() > 0

    def test_validation(self):
        import pytest

        with pytest.raises(ValueError, match="combine"):
            sk.sphere(1.0).repeat_indexed("x", (1.0,), self._palette(),
                                          combine="bogus")
        with pytest.raises(ValueError, match="axes"):
            sk.sphere(1.0).repeat_indexed("w", (1.0,), self._palette())
        with pytest.raises(ValueError, match="sizes"):
            sk.sphere(1.0).repeat_indexed("xy", (1.0,), self._palette())
