"""Registration tests mirroring the reference's KdTreeTests and
IterativeClosestPointTests scenarios (NN exactness; recovering known rigid
transforms within 1e-4 translation / 1e-6 rotation-diagonal; robustness to a
random 50% subset)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdfkit.registration.icp import (
    IterativeClosestPoint,
    NearestNeighbors,
    global_register_points,
    nearest_neighbors,
)

THREE_POINTS = np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.float32)


def rot_x(rad):
    """System.Numerics CreateRotationX, row-vector convention."""
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, s, -s, c
    return m


def rot_y(rad):
    c, s = np.cos(rad), np.sin(rad)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def translation(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = [x, y, z]
    return m


def apply(points, m):
    return points @ m[:3, :3] + m[3, :3]


class TestNearestNeighbors:
    def test_three_points(self):
        nn = NearestNeighbors(THREE_POINTS)
        assert nn.total_points == 3
        nearest, dist = nn.search(np.array([0.0, 1.5, 0.0]))
        np.testing.assert_array_equal(nearest, [0, 1, 0])
        assert abs(dist - 0.5) < 1e-4

    def test_random_points(self):
        rng = np.random.default_rng(0)
        pts = (1000.0 * (rng.random((10_000, 3)) * 2 - 1)).astype(np.float32)
        nn = NearestNeighbors(pts)
        qi = 1234
        offset = np.array([0.01, 0.01, 0.01], np.float32)
        nearest, dist = nn.search(pts[qi] + offset)
        np.testing.assert_array_equal(nearest, pts[qi])
        assert abs(dist - np.linalg.norm(offset)) < 1e-4

    def test_batch_search_matches_loop(self):
        rng = np.random.default_rng(1)
        pts = rng.random((500, 3)).astype(np.float32)
        qs = rng.random((40, 3)).astype(np.float32)
        idx, dist = nearest_neighbors(pts, qs)
        d2 = ((qs[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        np.testing.assert_array_equal(np.asarray(idx), d2.argmin(1))

    def test_chunking_consistent(self):
        rng = np.random.default_rng(2)
        pts = rng.random((5000, 3)).astype(np.float32)
        qs = rng.random((64, 3)).astype(np.float32)
        i1, d1 = nearest_neighbors(pts, qs, chunk=256)
        i2, d2 = nearest_neighbors(pts, qs, chunk=5000)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)

    def test_add_points(self):
        nn = NearestNeighbors(THREE_POINTS)
        nn.add_points([[5.0, 5.0, 5.0]])
        nearest, _ = nn.search(np.array([4.9, 5.0, 5.0]))
        np.testing.assert_array_equal(nearest, [5, 5, 5])


def _points_test(points, expected, keep=1.0, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random(len(points)) < keep
    sources = points[mask]
    transformed = apply(sources, expected)

    icp = IterativeClosestPoint(points)
    aligned, inv_transform = icp.register_points(transformed)
    recovered = np.linalg.inv(inv_transform)

    np.testing.assert_allclose(recovered[3, :3], expected[3, :3], atol=1e-4)
    for i in range(3):
        assert abs(recovered[i, i] - expected[i, i]) < 1e-6
    # Round trips: aligned points land back on the sources.
    np.testing.assert_allclose(aligned, sources, atol=1e-4)
    np.testing.assert_allclose(
        apply(transformed, inv_transform), sources, atol=1e-4
    )


class TestIcp:
    def test_three_points_offset_x(self):
        _points_test(THREE_POINTS, translation(0.1, 0, 0))

    def test_three_points_offset_xyz(self):
        _points_test(THREE_POINTS, translation(0.1, -0.2, -0.3))

    def test_three_points_rotate_y(self):
        _points_test(THREE_POINTS, rot_y(np.deg2rad(1.0)))

    def test_three_points_rotate_x_offset_y(self):
        _points_test(THREE_POINTS, rot_x(np.deg2rad(1.0)) @ translation(0, 0.1, 0))

    def test_three_points_composed(self):
        m = translation(0, 0, 0.1) @ rot_x(np.deg2rad(1.0)) @ translation(0, 0.1, 0)
        _points_test(THREE_POINTS, m)

    def test_random_points_half_kept(self):
        rng = np.random.default_rng(0)
        pts = (rng.random((100, 3)) - 0.5).astype(np.float32)
        m = translation(0, 0, 0.1) @ rot_x(np.deg2rad(1.0)) @ translation(0, 0.1, 0)
        _points_test(pts, m, keep=0.5)

    def test_global_register(self):
        rng = np.random.default_rng(3)
        base = (rng.random((200, 3)) - 0.5).astype(np.float32)
        m1 = translation(0.05, 0, 0)
        m2 = translation(0, 0.05, 0)
        scans = [base, apply(base, m1), apply(base, m2)]
        aligned, tfs = global_register_points(scans)
        assert len(aligned) == 3
        np.testing.assert_array_equal(tfs[0], np.eye(4))
        np.testing.assert_allclose(aligned[1], base, atol=1e-3)
        np.testing.assert_allclose(aligned[2], base, atol=1e-3)

    def test_global_register_empty_and_single(self):
        assert global_register_points([]) == ([], [])
        a, t = global_register_points([THREE_POINTS])
        assert len(a) == 1 and len(t) == 1


class TestJaxIcp:
    """Differentiable on-device ICP (register_points_jax): parity with the
    numpy reference path plus gradient flow."""

    def test_parity_with_numpy_path(self):
        from sdfkit.registration.icp import register_points_jax

        rng = np.random.default_rng(4)
        pts = (rng.random((80, 3)) - 0.5).astype(np.float32)
        m = translation(0.05, -0.02, 0.03) @ rot_y(np.deg2rad(1.0))
        transformed = apply(pts, m)

        aligned_np, inv_np = IterativeClosestPoint(pts).register_points(
            transformed
        )
        aligned_j, inv_j = register_points_jax(pts, transformed)
        np.testing.assert_allclose(np.asarray(aligned_j), aligned_np, atol=1e-4)
        np.testing.assert_allclose(np.asarray(inv_j), inv_np, atol=1e-4)
        # And it actually solved the problem: round trip to the sources.
        np.testing.assert_allclose(np.asarray(aligned_j), pts, atol=1e-3)

    def test_gradient_through_alignment(self):
        import jax
        import jax.numpy as jnp

        from sdfkit.registration.icp import register_points_jax

        rng = np.random.default_rng(5)
        pts = (rng.random((50, 3)) - 0.5).astype(np.float32)

        def loss(theta):
            c, s = jnp.cos(theta), jnp.sin(theta)
            r = jnp.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
            scan = pts @ r + jnp.array([0.05, 0.0, 0.0])
            aligned, _ = register_points_jax(pts, scan, max_iterations=10)
            return jnp.mean((aligned - pts) ** 2)

        g = jax.grad(loss)(jnp.float32(0.02))
        assert np.isfinite(float(g))
        # Finite-difference check: the analytic gradient matches.
        eps = 1e-3
        fd = (float(loss(jnp.float32(0.02 + eps)))
              - float(loss(jnp.float32(0.02 - eps)))) / (2 * eps)
        assert abs(float(g) - fd) < max(0.2 * abs(fd), 1e-4)


class TestOutlierRejection:
    def test_far_outliers_rejected(self):
        """Pathological fixture for the far-outlier branch
        (dist_mean > 6 * good -> dist_max = mean + 0.5 + std, the stand-in
        for the reference's valley-after-peak heuristic,
        IterativeClosestPoint.cs:111-114): gross outliers 10 units away must
        not corrupt the recovered transform."""
        rng = np.random.default_rng(6)
        pts = (rng.random((200, 3)) - 0.5).astype(np.float32)
        m = translation(0.08, 0.0, -0.05)
        transformed = apply(pts, m).astype(np.float32)
        # 5 gross outliers: mean NN distance starts > 6 * good (0.06).
        outliers = np.array(
            [[10.0, 10.0, 10.0], [-10, 8, 9], [9, -10, 8], [8, 9, -10],
             [10, 0, -10]],
            np.float32,
        )
        scan = np.concatenate([transformed, outliers])

        icp = IterativeClosestPoint(pts)
        aligned, inv_transform = icp.register_points(scan)
        recovered = np.linalg.inv(inv_transform)
        np.testing.assert_allclose(recovered[3, :3], m[3, :3], atol=5e-3)
        # Inliers land back on the sources despite the outliers.
        np.testing.assert_allclose(aligned[:200], pts, atol=5e-3)


class TestOutlierBranches:
    """The reference's 4-branch robust-distance cutoff, transliterated and
    pinned (IterativeClosestPoint.cs:101-114). The fourth branch's C# comment
    quotes the ICP paper's "valley after the maximal peak" rule, but the
    reference CODE is `distMean + 0.5f + distStd` — no histogram exists, so
    that constant formula IS exact parity."""

    def test_all_four_branches(self):
        from sdfkit.registration.icp import robust_distance_cutoff

        good = 0.01
        # branch 1: mean < good -> mean + 3 std
        assert robust_distance_cutoff(0.005, 0.1, good) == 0.005 + 3 * 0.1
        # branch 2: mean < 3*good -> mean + 2 std
        assert robust_distance_cutoff(0.02, 0.1, good) == 0.02 + 2 * 0.1
        # branch 3: mean < 6*good -> mean + std
        assert robust_distance_cutoff(0.05, 0.1, good) == 0.05 + 0.1
        # branch 4 (the "valley" quote): mean + 0.5 + std, verbatim
        assert robust_distance_cutoff(0.5, 0.1, good) == 0.5 + 0.5 + 0.1

    def test_bimodal_far_cluster_branch4(self):
        # A bimodal distance distribution that lands in branch 4: near
        # cluster at ~0.2, far cluster at ~2.0 (mean ~0.65 > 6*good). The
        # reference formula keeps a point iff dist <= mean + 0.5 + std; pin
        # which side of the cutoff each cluster falls on.
        from sdfkit.registration.icp import robust_distance_cutoff

        dist = np.concatenate([np.full(75, 0.2), np.full(25, 2.0)])
        mean, std = dist.mean(), dist.std()
        cutoff = robust_distance_cutoff(float(mean), float(std))
        assert mean > 6 * 0.01  # branch 4 selected
        assert (dist[:75] <= cutoff).all()  # near cluster kept
        assert (dist[75:] > cutoff).all()  # far cluster rejected
        # An actual histogram-valley rule (cut between the two modes, e.g.
        # at ~1.0) would also reject the far cluster here but DISAGREES when
        # the far mode sits within mean+0.5+std; pin that disagreement case
        # to document that we follow the reference's code, not its comment.
        dist2 = np.concatenate([np.full(80, 0.1), np.full(20, 0.8)])
        mean2, std2 = dist2.mean(), dist2.std()
        cutoff2 = robust_distance_cutoff(float(mean2), float(std2))
        assert mean2 > 6 * 0.01
        assert (dist2 <= cutoff2).all()  # reference keeps BOTH modes here


class TestFastPathDefault:
    """register_points routes through the one-dispatch jit'd scan by default;
    parity=True keeps the reference-mirroring numpy
    loop; modified thresholds force the numpy path."""

    def test_default_matches_parity(self):
        rng = np.random.default_rng(3)
        static = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = [0.02, -0.01, 0.015]
        moved = static @ t[:3, :3] + t[3, :3]
        icp = IterativeClosestPoint(static)
        a_par, tf_par = icp.register_points(moved, parity=True)
        a_dev, tf_dev = icp.register_points(moved, parity=False)
        np.testing.assert_allclose(a_dev, a_par, atol=1e-4)
        np.testing.assert_allclose(tf_dev, tf_par, atol=1e-4)

    def test_modified_thresholds_use_numpy(self):
        rng = np.random.default_rng(4)
        static = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        icp = IterativeClosestPoint(static)
        icp.max_iterations = 5  # non-default -> parity path must be chosen
        calls = []
        orig = icp._iter_transform

        def spy(pts):
            calls.append(1)
            return orig(pts)

        icp._iter_transform = spy
        icp.register_points(static + 0.01)
        assert 1 <= len(calls) <= 5  # the numpy loop (early exit) ran


class TestGridNN:
    """The grid-bucket NN index (registration/icp.py GridNN) must answer
    IDENTICALLY to the brute-force kernel — same indices (lowest-index tie
    breaking) and bitwise-same recomputed distances — with the unguaranteed
    queries repaired by brute force."""

    def test_identical_to_brute_force_uniform(self):
        from sdfkit.registration.icp import (
            GridNN, nearest_neighbors,
        )

        rng = np.random.default_rng(3)
        pts = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
        q = rng.uniform(-1.2, 1.2, (3000, 3)).astype(np.float32)
        grid = GridNN(pts)
        assert grid.ok
        gi, gd = grid.query(q)
        bi, bd = nearest_neighbors(pts, q)
        np.testing.assert_array_equal(gi, np.asarray(bi))
        # numpy host recompute vs XLA's (FMA-contracted) device recompute
        # differ by at most one ulp.
        np.testing.assert_allclose(gd, np.asarray(bd), rtol=2e-7)

    def test_identical_on_clustered_and_outlier_queries(self):
        from sdfkit.registration.icp import (
            GridNN, nearest_neighbors,
        )

        rng = np.random.default_rng(4)
        # Two mild clusters + a sparse shell; queries include far outliers
        # (every 27-block empty -> full brute-force repair path) and
        # clustered queries (slot-overflow -> repair).
        pts = np.concatenate([
            rng.normal(0, 1.0, (5000, 3)),
            rng.normal(2, 1.0, (5000, 3)),
            rng.uniform(-3, 3, (500, 3)),
        ]).astype(np.float32)
        q = np.concatenate([
            rng.normal(0, 0.1, (500, 3)),   # piled into few cells
            rng.uniform(-20, 20, (100, 3)),
        ]).astype(np.float32)
        grid = GridNN(pts)
        assert grid.ok
        gi, gd = grid.query(q)
        bi, bd = nearest_neighbors(pts, q)
        np.testing.assert_array_equal(gi, np.asarray(bi))
        np.testing.assert_allclose(gd, np.asarray(bd), rtol=2e-7)

    def test_degenerate_clustering_declines(self):
        from sdfkit.registration.icp import GridNN

        rng = np.random.default_rng(7)
        # Thousands of points in one bucket: the dense O(G^3 K Kq) layout
        # must decline (callers then use the brute matmul kernel) — even with
        # the bucket cap lifted, the memory guard holds.
        pts = np.concatenate([
            rng.normal(0, 0.01, (5000, 3)),
            rng.uniform(-3, 3, (200, 3)),
        ]).astype(np.float32)
        assert not GridNN(pts, max_bucket=10**6).ok

    def test_nearest_neighbors_class_routes_large_sets(self):
        from sdfkit.registration.icp import NearestNeighbors

        rng = np.random.default_rng(5)
        pts = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        brute = NearestNeighbors(pts, grid_min_points=10**9)
        grid = NearestNeighbors(pts, grid_min_points=1)
        bp, bdist = brute.search(q)
        gp, gdist = grid.search(q)
        np.testing.assert_array_equal(bp, gp)
        np.testing.assert_allclose(bdist, gdist, rtol=2e-7)

    def test_icp_registration_matches_brute_on_fixture(self):
        from sdfkit.registration.icp import IterativeClosestPoint

        rng = np.random.default_rng(6)
        static = rng.uniform(-1, 1, (6000, 3)).astype(np.float32)
        # Small known transform (translation + small rotation).
        ang = 0.02
        r = np.array([
            [np.cos(ang), -np.sin(ang), 0],
            [np.sin(ang), np.cos(ang), 0],
            [0, 0, 1],
        ], np.float32)
        moved = (static @ r.T + np.array([0.01, -0.02, 0.015], np.float32))

        icp_b = IterativeClosestPoint(static)
        icp_b._nn._grid_min = 10**9  # force brute force
        icp_g = IterativeClosestPoint(static)
        icp_g._nn._grid_min = 1  # force grid index
        pb, tb = icp_b.register_points(moved, parity=True)
        pg, tg = icp_g.register_points(moved, parity=True)
        np.testing.assert_allclose(tb, tg, atol=1e-6)
        np.testing.assert_allclose(pb, pg, atol=1e-5)


class TestGridScanIcp:
    """The grid-bucket NN running INSIDE the one-dispatch lax.scan ICP
    (register_points_jax nn='grid'): same trajectory as
    the brute scan and the host loop, differentiable, one dispatch."""

    def _fixture(self, n=4000, m=2000, seed=1):
        rng = np.random.default_rng(seed)
        static = rng.random((n, 3)).astype(np.float32) * 2 - 1
        ang = 0.05
        r = np.array([
            [np.cos(ang), -np.sin(ang), 0],
            [np.sin(ang), np.cos(ang), 0],
            [0, 0, 1],
        ], np.float32)
        moved = static[:m] @ r.T + np.array([0.02, -0.015, 0.01], np.float32)
        return static, moved

    def test_matches_brute_scan_exactly(self):
        from sdfkit.registration.icp import register_points_jax

        static, moved = self._fixture()
        ab, tb = register_points_jax(static, moved, nn="brute")
        ag, tg = register_points_jax(static, moved, nn="grid")
        # Exact NN + brute-repaired near-ties => identical correspondences
        # every iteration => identical transforms to float rounding.
        np.testing.assert_allclose(
            np.asarray(tg), np.asarray(tb), atol=2e-6
        )
        np.testing.assert_allclose(
            np.asarray(ag), np.asarray(ab), atol=2e-5
        )

    def test_matches_host_loop(self):
        from sdfkit.registration.icp import (
            IterativeClosestPoint, register_points_jax)

        static, moved = self._fixture(seed=2)
        ag, tg = register_points_jax(static, moved, nn="grid")
        icp = IterativeClosestPoint(static)
        ah, th = icp.register_points(moved, parity=True)
        np.testing.assert_allclose(np.asarray(tg), th, atol=5e-4)
        assert np.abs(np.asarray(ag) - static[:2000]).max() < 5e-3

    def test_gradient_flows_through_grid_scan(self):
        from sdfkit.registration.icp import register_points_jax

        static, moved = self._fixture()

        def loss(mv):
            a, _ = register_points_jax(
                static, mv, max_iterations=6, nn="grid"
            )
            return jnp.sum((a - jnp.asarray(static[:2000])) ** 2)

        g = jax.grad(loss)(jnp.asarray(moved))
        assert bool(jnp.isfinite(g).all())

    def test_repair_cap_fallback_matches(self):
        # Force the full-brute cond branch by shrinking the repair cap: a
        # badly misaligned start makes most queries unguaranteed.
        from sdfkit.registration import icp as icp_mod

        static, moved = self._fixture(seed=3)
        moved = moved + np.float32(0.5)  # big offset: many unguaranteed
        a1, t1 = icp_mod.register_points_jax(static, moved, nn="brute")
        old = icp_mod.ICP_GRID_REPAIR_CAP
        icp_mod.ICP_GRID_REPAIR_CAP = 8
        try:
            icp_mod._register_points_jax_grid.clear_cache()
            a2, t2 = icp_mod.register_points_jax(static, moved, nn="grid")
        finally:
            icp_mod.ICP_GRID_REPAIR_CAP = old
            icp_mod._register_points_jax_grid.clear_cache()
        np.testing.assert_allclose(np.asarray(t2), np.asarray(t1), atol=2e-5)

    def test_grid_mode_errors_on_degenerate_build(self):
        from sdfkit.registration.icp import register_points_jax

        pts = np.zeros((3000, 3), np.float32)  # all in one bucket
        import pytest

        with pytest.raises(ValueError, match="grid NN index declined"):
            register_points_jax(pts, pts[:10], nn="grid")


class TestGridNNEdgeCases:
    def test_single_query_and_duplicate_points(self):
        from sdfkit.registration.icp import GridNN, nearest_neighbors

        rng = np.random.default_rng(9)
        base = rng.random((3000, 3)).astype(np.float32)
        # Exact duplicates: ties must break to the LOWEST original index
        # in both paths (the near-tie rule sends them to brute repair).
        pts = np.concatenate([base, base[:500]])
        grid = GridNN(pts)
        assert grid.ok
        q = base[250:251] + np.float32(1e-4)
        gi, gd = grid.query(q)
        bi, bd = nearest_neighbors(pts, q)
        np.testing.assert_array_equal(gi, np.asarray(bi))
        assert int(gi[0]) == 250  # not the duplicate at 3250

    def test_all_queries_one_cell_overflow_repair(self):
        from sdfkit.registration.icp import GridNN, nearest_neighbors

        rng = np.random.default_rng(10)
        pts = rng.random((4000, 3)).astype(np.float32)
        grid = GridNN(pts)
        assert grid.ok
        # Far more queries than Kq slots, all in one cell: the overflow
        # slots must be brute-repaired, answers still exact.
        q = (np.float32(0.5) + rng.random((grid.Kq * 5, 3)).astype(np.float32)
             * np.float32(1e-3))
        gi, gd = grid.query(q)
        bi, bd = nearest_neighbors(pts, q)
        np.testing.assert_array_equal(gi, np.asarray(bi))
