"""The C++ host kernels (sdfkit/native/sparse_phase.cc) vs their numpy
references. Welding must be BITWISE identical (it decides vertex identity and
ordering, hence golden vertex counts); gradient accumulation must agree to
float tolerance (the C++ single pass and numpy's multiplicity-compressed
passes round differently at the ulp level)."""

import os

import numpy as np
import pytest

from sdfkit import native
from sdfkit.mesh import luts
from sdfkit.mesh.marching_cubes import FLT_EPSILON, _corner_gradients

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain"
)


def numpy_weld(keys):
    uniq, first_idx, inv = np.unique(
        keys, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inv], first_idx[order]


class TestWeld:
    def test_matches_numpy_random(self):
        rng = np.random.default_rng(0)
        keys = rng.integers(0, 5000, 200_000).astype(np.int64)
        vid_c, rep_c = native.weld(keys)
        vid_np, rep_np = numpy_weld(keys)
        np.testing.assert_array_equal(vid_c, vid_np)
        np.testing.assert_array_equal(rep_c, rep_np)

    def test_matches_numpy_edge_cases(self):
        for keys in (
            np.array([7], np.int64),
            np.array([3, 3, 3], np.int64),
            np.array([5, 1, 5, 1, 2], np.int64),
            np.arange(100, dtype=np.int64)[::-1].copy(),
        ):
            vid_c, rep_c = native.weld(keys)
            vid_np, rep_np = numpy_weld(keys)
            np.testing.assert_array_equal(vid_c, vid_np)
            np.testing.assert_array_equal(rep_c, rep_np)


class TestGradEdges:
    def test_matches_numpy_per_entry(self):
        rng = np.random.default_rng(1)
        m, n, n_verts = 500, 20_000, 700
        v8 = rng.normal(size=(8, m))
        vg = _corner_gradients(v8)
        evi = rng.integers(0, 12, n).astype(np.uint8)
        ecell = rng.integers(0, m, n).astype(np.int64)
        vid = rng.integers(0, n_verts, n).astype(np.int64)

        normals_c = np.zeros((n_verts, 3), np.float32)
        native.grad_edges(evi, ecell, vid, v8, vg, normals_c, FLT_EPSILON)

        # Per-entry numpy reference (no multiplicity compression).
        p1 = luts.EDGE_P1[evi]
        p2 = luts.EDGE_P2[evi]
        va = v8[luts.EDGE_MC1[evi], ecell]
        vb = v8[luts.EDGE_MC2[evi], ecell]
        t1 = (1.0 / (FLT_EPSILON + np.abs(va))).astype(np.float32)
        t2 = (1.0 / (FLT_EPSILON + np.abs(vb))).astype(np.float32)
        contrib = vg[p1, ecell] * t1[:, None] + vg[p2, ecell] * t2[:, None]
        normals_np = np.zeros((n_verts, 3), np.float32)
        np.add.at(normals_np, vid, contrib)

        np.testing.assert_allclose(normals_c, normals_np, rtol=1e-5, atol=1e-4)


def test_mesh_native_vs_numpy_path():
    """End to end on the SAME voxels: to_mesh with the C++ kernels vs the
    numpy fallback (SDFKIT_NO_NATIVE=1). Vertex identity, order, counts,
    positions and colors identical (welding is bitwise-equal and everything
    downstream of it is shared code); normals allclose (the C++ single pass
    and numpy's multiplicity-compressed accumulation round differently)."""
    import sdfkit as sk

    v = sk.voxelize(sk.sphere(0.5), (-1.0,) * 3, (1.0,) * 3, 32, 32, 32)
    m = v.to_mesh()
    assert len(m.vertices) == 1248  # golden via the native path

    os.environ["SDFKIT_NO_NATIVE"] = "1"
    try:
        m_np = v.to_mesh()
    finally:
        del os.environ["SDFKIT_NO_NATIVE"]
    np.testing.assert_array_equal(m.vertices, m_np.vertices)
    np.testing.assert_array_equal(m.triangles, m_np.triangles)
    np.testing.assert_array_equal(m.colors, m_np.colors)
    np.testing.assert_allclose(m.normals, m_np.normals, atol=1e-4)


class TestMcSparseFull:
    """The single-pass C++ geometry kernel (mc_host.cc mc_sparse_run) against
    the vectorized numpy sparse phase, through the public create_mesh:
    vertices and triangles must be BITWISE identical (same dispatch, same
    first-occurrence welding, same f64 interpolation), normals/colors to
    float tolerance (accumulation order differs)."""

    def _compare(self, scene, n, lo=-1.5, hi=1.5):
        import sdfkit as sk
        from sdfkit.mesh import marching_cubes as mc

        v = sk.voxelize(scene, (lo,) * 3, (hi,) * 3, n, n, n)
        os.environ["SDFKIT_NO_NATIVE"] = "1"
        try:
            m_np = mc.create_mesh(v)
        finally:
            del os.environ["SDFKIT_NO_NATIVE"]
        m_cc = mc.create_mesh(v)
        np.testing.assert_array_equal(m_np.vertices, m_cc.vertices)
        np.testing.assert_array_equal(m_np.triangles, m_cc.triangles)
        np.testing.assert_allclose(
            m_np.normals, m_cc.normals, atol=2e-5, rtol=0
        )
        np.testing.assert_allclose(
            m_np.colors, m_cc.colors, atol=1e-6, rtol=0
        )
        return m_cc

    def test_sphere_small(self):
        import sdfkit as sk

        m = self._compare(sk.sphere(1.0), 5)
        assert len(m.vertices) == 54  # reference golden

    def test_csg_color_scene(self):
        import sdfkit as sk

        scene = sk.sphere(1.0, color=(1.0, 0.2, 0.1)) | sk.box(
            (0.4, 0.9, 0.6), color=(0.1, 0.9, 0.2)
        ).translate((0.5, 0.2, 0.0))
        self._compare(scene, 33)

    def test_torus_union(self):
        import sdfkit as sk

        scene = sk.torus(0.9, 0.35) | sk.sphere(0.5).translate(
            (0.0, 0.0, 0.8)
        )
        self._compare(scene, 50)


class TestSequentialBaseline:
    """The reference-style single-threaded C++ baseline (mc_host.cc
    mc_sequential_baseline) must agree with create_mesh on vertex count —
    it is the measured stand-in for the reference's sequential meshing loop
    in bench.py, so its work has to be the same surface."""

    def test_counts_match_create_mesh(self):
        import sdfkit as sk
        from sdfkit.mesh import marching_cubes as mc

        v = sk.voxelize(sk.sphere(0.5), (-1.0,) * 3, (1.0,) * 3, 32, 32, 32)
        m = mc.create_mesh(v)
        n_verts, stream_len = native.mc_sequential_baseline(
            np.asarray(v.values), np.asarray(v.colors), 1, 0.0
        )
        assert n_verts == len(m.vertices) == 1248  # reference golden
        assert stream_len == len(m.triangles)

    def test_counts_match_no_colors(self):
        import sdfkit as sk
        from sdfkit.mesh import marching_cubes as mc

        v = sk.voxelize(
            sk.torus(0.9, 0.35), (-1.5,) * 3, (1.5,) * 3, 24, 24, 24
        )
        m = mc.create_mesh(v)
        n_verts, stream_len = native.mc_sequential_baseline(
            np.asarray(v.values), None, 1, 0.0
        )
        assert n_verts == len(m.vertices)
        assert stream_len == len(m.triangles)


def test_native_path_actually_taken():
    """Guard against silent numpy fallback: a wrapper bug once made
    McSparse.geometry() return None (falsy), so every mesh quietly took the
    numpy path while all parity tests still passed (both sides were numpy).
    The phase timings name which path ran — pin it."""
    import sdfkit as sk
    from sdfkit.mesh import marching_cubes as mc

    v = sk.voxelize(sk.sphere(0.5), (-1.0,) * 3, (1.0,) * 3, 24, 24, 24)
    mc.create_mesh(v)
    assert "native_geometry_ms" in mc.LAST_TIMINGS, mc.LAST_TIMINGS
    assert "dispatch_weld_ms" not in mc.LAST_TIMINGS  # the numpy-path key


def test_mc_sparse_geometry_rejects_mismatched_points():
    """The C++ phase-B entry must refuse (return False) when the point-value
    count disagrees with its bitmap rank — the host/device-inconsistency
    guard that triggers the numpy fallback in create_mesh."""
    import sdfkit as sk
    from sdfkit.mesh import luts

    v = sk.voxelize(sk.sphere(0.5), (-1.0,) * 3, (1.0,) * 3, 12, 12, 12)
    vals = np.asarray(v.values)
    n = 12
    inside = vals > np.float32(0.0)
    c = np.zeros((n - 1,) * 3, np.uint8)
    for k in range(8):
        dx = int(luts.CORNER_DX[k])
        dy = int(luts.CORNER_DY[k])
        dz = int(luts.CORNER_DZ[k])
        c |= (
            inside[dx : dx + n - 1, dy : dy + n - 1, dz : dz + n - 1]
            .astype(np.uint8) << k
        )
    am = ((c != 0) & (c != 255)).transpose(2, 1, 0).reshape(-1)
    active = np.flatnonzero(am).astype(np.int64)
    mc = native.McSparse(active, n - 1, n - 1, n - 1, n, n, n, 1, 0.0)
    assert mc.ok
    try:
        assert mc.geometry(np.zeros(3, np.float32)) is False  # wrong count
        assert mc.ok is False
    finally:
        mc.close()


def test_mc_sparse_chunked_pvals_guards():
    """The chunked point-value flow (split z-transfers): totals that
    disagree with the bitmap rank must be detectable BEFORE the final
    geometry chunk (expected_points), and the per-range rank probe
    (expected_points_below) must match a direct popcount of the host
    corner bitmap — these are what _sparse_phase_native verifies before
    touching partial buffers."""
    import sdfkit as sk
    from sdfkit.mesh import luts

    v = sk.voxelize(sk.sphere(0.5), (-1.0,) * 3, (1.0,) * 3, 12, 12, 12)
    vals = np.asarray(v.values)
    n = 12
    inside = vals > np.float32(0.0)
    c = np.zeros((n - 1,) * 3, np.uint8)
    for k in range(8):
        dx = int(luts.CORNER_DX[k])
        dy = int(luts.CORNER_DY[k])
        dz = int(luts.CORNER_DZ[k])
        c |= (
            inside[dx : dx + n - 1, dy : dy + n - 1, dz : dz + n - 1]
            .astype(np.uint8) << k
        )
    am = ((c != 0) & (c != 255)).transpose(2, 1, 0).reshape(-1)
    active = np.flatnonzero(am).astype(np.int64)
    lx = n - 1
    mc = native.McSparse(active, lx, lx, lx, n, n, n, 1, 0.0)
    assert mc.ok
    try:
        # Host-side oracle: unique corner points of the active cells.
        acx = active % lx
        acy = (active // lx) % lx
        acz = active // (lx * lx)
        cp = (
            (acz[None, :] + luts.CORNER_DZ.astype(np.int64)[:, None])
            * (lx + 1)
            + (acy[None, :] + luts.CORNER_DY.astype(np.int64)[:, None])
        ) * (lx + 1) + (
            acx[None, :] + luts.CORNER_DX.astype(np.int64)[:, None]
        )
        uniq = np.unique(cp.reshape(-1))
        assert mc.expected_points() == uniq.size
        plane = (lx + 1) * (lx + 1)
        for zsplit in (1, 3, lx // 2, lx + 1):
            assert mc.expected_points_below(zsplit * plane) == int(
                (uniq < zsplit * plane).sum()
            )
        # A short first chunk + a correct-total check catches the mismatch.
        mc.pvals_chunk(np.zeros(3, np.float32))
        assert mc.expected_points() != 3
    finally:
        mc.close()


def test_threaded_geometry_matches_direct():
    """Both C++ dedup implementations — the direct rolling-layer path and
    the threaded worker+merge path — must produce identical meshes. The
    auto rule picks exactly ONE per machine (by core count), so this forces
    each in turn via the worker-count override; without it the threaded
    path would never run under the suite on small hosts."""
    import sdfkit as sk

    s = sk.sphere(0.8).union(sk.torus(0.6, 0.25))
    vox = sk.voxelize(s, (-1.2,) * 3, (1.2,) * 3, 64, 64, 64)
    try:
        native.set_geo_workers(1)
        m_direct = vox.to_mesh()
        native.set_geo_workers(3)  # force threaded with a real multi-merge
        m_threaded = vox.to_mesh()
    finally:
        native.set_geo_workers(-1)
    assert len(m_direct.vertices) > 1000
    np.testing.assert_array_equal(m_threaded.vertices, m_direct.vertices)
    np.testing.assert_array_equal(m_threaded.triangles, m_direct.triangles)
    np.testing.assert_array_equal(m_threaded.colors, m_direct.colors)
    # Normal ACCUMULATION differs in structure (inline-in-stream vs the
    # deferred pass) but both walk the same stream order — bit-identical.
    np.testing.assert_array_equal(m_threaded.normals, m_direct.normals)


def test_four_chunk_pipeline_with_step_and_iso():
    """The K-chunk point-value pipeline (4 chunks past 96 cell layers) with
    step > 1 and iso != 0: chunk edges are in CELL z units and the per-range
    rank guards are step-independent — pin that by comparing the native
    pipeline against the numpy oracle on a grid deep enough to take the
    4-chunk path at step 2."""
    import os

    import sdfkit as sk

    s = sk.sphere(0.9).union(sk.box(0.5))
    vox = sk.voxelize(s, (-1.3,) * 3, (1.3,) * 3, 200, 64, 200)
    m_nat = vox.to_mesh(iso_value=0.05, step=2)
    os.environ["SDFKIT_NO_NATIVE"] = "1"
    try:
        m_np = vox.to_mesh(iso_value=0.05, step=2)
    finally:
        del os.environ["SDFKIT_NO_NATIVE"]
    assert len(m_nat.vertices) > 500
    np.testing.assert_array_equal(m_nat.vertices, m_np.vertices)
    np.testing.assert_array_equal(m_nat.triangles, m_np.triangles)
    np.testing.assert_array_equal(m_nat.colors, m_np.colors)
    np.testing.assert_allclose(m_nat.normals, m_np.normals, atol=2e-5, rtol=0)
