"""Marching cubes parity tests — golden vertex counts from the reference
(Tests/MarchingCubesTests.cs). These counts are sensitive to every detail of
the MC33 dispatch, ambiguity resolution, and vertex welding, so they pin the
whole pipeline.
"""

import numpy as np
import pytest

import sdfkit as sk


def mesh_of(expr, lo, hi, n, clip=True, **kw):
    v = sk.voxelize(expr, (lo,) * 3, (hi,) * 3, n, n, n, clip_to_bounds=clip)
    return v.to_mesh(**kw)


class TestGoldenCounts:
    def test_sphere5(self):
        m = mesh_of(sk.sphere(1.0), -1.5, 1.5, 5)
        assert len(m.vertices) == 54
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 1.0) < 0.3

    def test_sphere10(self):
        m = mesh_of(sk.sphere(2.0), -2.5, 2.5, 10)
        assert len(m.vertices) == 312
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 2.0) < 0.2

    def test_box10(self):
        m = mesh_of(sk.box(2.0), -2.5, 2.5, 10)
        assert len(m.vertices) == 384
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 2.0) < 0.3

    def test_unclipped_sphere_empty(self):
        # Sphere larger than volume, unclipped: no crossings, no mesh.
        m = mesh_of(sk.sphere(2.0), -1.0, 1.0, 10, clip=False)
        assert len(m.vertices) == 0
        assert len(m.triangles) == 0

    def test_clipped_sphere(self):
        m = mesh_of(sk.sphere(2.0), -1.0, 1.0, 10, clip=True)
        assert len(m.vertices) == 384
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] - 2.0) < 1e-1

    def test_cylinder50(self):
        v = sk.voxelize(
            sk.cylinder(1.0, 3.0), (-1.5, -3.5, -1.5), (1.5, 3.5, 1.5), 50, 50, 50
        )
        m = v.to_mesh()
        assert len(m.vertices) == 7456
        assert np.abs(m.center).max() < 1e-6
        assert abs(m.size[0] / 2 - 1.0) < 1e-1

    def test_sphere128_progress(self):
        got = []
        v = sk.voxelize(sk.sphere(3.0), (-3.1,) * 3, (3.1,) * 3, 128, 128, 128)
        m = v.to_mesh(progress=got.append)
        assert len(m.vertices) == 72240
        assert all(0.0 <= f <= 1.0 for f in got)
        # Live progress (the reference reports once per z layer DURING its
        # loop, MarchingCubes.cs:81; Tests/MarchingCubesTests.cs:141-171
        # asserts intermediate values arrive): the sequence must start at
        # 0.0, end at 1.0, be monotone non-decreasing, and contain many
        # distinct intermediate values — not just the endpoints replayed
        # after the fact.
        assert got[0] == 0.0
        assert got[-1] == 1.0
        assert got == sorted(got)
        assert len(set(got)) > 100  # one value per z layer (126 layers)
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 3.0) < 0.1


class TestColors:
    def test_colored_spheres(self):
        # MarchingCubesTests.ColoredSpheres: 104 verts, first vertex red-ish.
        s = sk.union(
            sk.sphere(0.4, color=(1.0, 0.2, 0.3)).translate(-1, 0, 0),
            sk.sphere(0.2, color=(0.1, 1.0, 0.3)).translate(1, 0, 0),
        )
        m = mesh_of(s, -3.0, 3.0, 32)
        assert len(m.vertices) == 104
        assert len(m.colors) == 104
        assert m.colors[0][0] > 0.5


class TestMeshProperties:
    def test_normals_point_outward(self):
        m = mesh_of(sk.sphere(2.0), -2.5, 2.5, 16)
        # For a sphere at origin, normals should align with vertex direction.
        v = m.vertices / np.linalg.norm(m.vertices, axis=1, keepdims=True)
        dots = (v * m.normals).sum(axis=1)
        assert dots.mean() > 0.9

    def test_normals_unit_length(self):
        m = mesh_of(sk.sphere(2.0), -2.5, 2.5, 10)
        np.testing.assert_allclose(
            np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-5
        )

    def test_triangles_index_valid(self):
        m = mesh_of(sk.sphere(2.0), -2.5, 2.5, 10)
        assert len(m.triangles) % 3 == 0
        assert m.triangles.min() >= 0
        assert m.triangles.max() < len(m.vertices)

    def test_step2(self):
        # step=2 on a 20-grid visits cells x,y,z in {0,2,...,16} — the same
        # 9-cell cadence as a 10-grid (the reference's `while (x < n-2*step)
        # { x += step; }` loops, MarchingCubes.cs:53-66) but at the 20-grid's
        # cell-center sample positions. Pinned count: 312 vertices (equal to
        # the 10-grid golden by the sphere's symmetry).
        m1 = mesh_of(sk.sphere(2.0), -2.5, 2.5, 20, **{"step": 2})
        assert len(m1.vertices) == 312
        assert abs(m1.size[0] / 2 - 2.0) < 0.3

    def test_step2_odd_extent(self):
        # Odd grid extent with step=2: the last visited cell coordinate is
        # the largest multiple of step strictly below n-step (18 for n=21),
        # whose +step corner touches the final layer. Pins the bound math.
        m = mesh_of(sk.sphere(2.0), -2.5, 2.5, 21, **{"step": 2})
        assert len(m.vertices) == 342
        assert abs(m.size[0] / 2 - 2.0) < 0.3

    def test_iso_value_offset(self):
        # iso=0.5 on a sphere of r=1 extracts the r=1.5 shell. clip=False:
        # the wall outside-value (size/nx ~ 0.21) sits below iso 0.5, so
        # clipping would read the walls as "inside" (reference ClipToBounds
        # assumes iso 0, Voxels.cs:133-167).
        m = mesh_of(sk.sphere(1.0), -2.5, 2.5, 24, clip=False, iso_value=0.5)
        r = np.linalg.norm(m.vertices, axis=1)
        assert abs(np.median(r) - 1.5) < 0.1

    def test_obj_export(self, tmp_path):
        m = mesh_of(sk.sphere(1.0), -1.5, 1.5, 5)
        p = tmp_path / "sphere.obj"
        m.write_obj(p)
        text = p.read_text().splitlines()
        nv = sum(1 for l in text if l.startswith("v "))
        nn = sum(1 for l in text if l.startswith("vn "))
        nf = sum(1 for l in text if l.startswith("f "))
        assert nv == 54 and nn == 54
        assert nf == len(m.triangles) // 3
        # 1-based i//i format
        assert text[-1].startswith("f ") and "//" in text[-1]

    def test_mesh_transform_roundtrip(self):
        m = mesh_of(sk.sphere(1.0), -1.5, 1.5, 8)
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = [1.0, 2.0, 3.0]  # row-vector translation
        m2 = m.transform(t)
        np.testing.assert_allclose(m2.center, m.center + [1, 2, 3], atol=1e-5)
        np.testing.assert_allclose(m2.normals, m.normals, atol=1e-5)
