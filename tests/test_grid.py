"""Voxel grid sampling tests — golden semantics from the reference
(Tests/VolumeTests.cs): cell-center sampling, grid dims/world size, clipping.
"""

import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from sdfkit.ops.grid import cell_centers


class TestCellCenters:
    def test_single_cell_is_center(self):
        # VolumeTests.cs:41-58: 1x1x1 grid over [-1,1]^3 samples at (0,0,0).
        p = cell_centers((-1, -1, -1), (1, 1, 1), 1, 1, 1)
        np.testing.assert_allclose(
            [float(p.x[0, 0, 0]), float(p.y[0, 0, 0]), float(p.z[0, 0, 0])],
            [0.0, 0.0, 0.0],
            atol=1e-6,
        )

    def test_3cube_contains_origin(self):
        # VolumeTests.cs:61-80: 3^3 over [-1,1]^3 visits (0,0,0) at center cell.
        p = cell_centers((-1, -1, -1), (1, 1, 1), 3, 3, 3)
        np.testing.assert_allclose(
            [float(p.x[1, 1, 1]), float(p.y[1, 1, 1]), float(p.z[1, 1, 1])],
            [0.0, 0.0, 0.0],
            atol=1e-6,
        )

    def test_positions_encode(self):
        # SDF-as-spy analogue: encode position into the distance channel.
        probe = sk.solid(lambda p: p.x + 10.0 * p.y + 100.0 * p.z)
        v = sk.voxelize(probe, (0, 0, 0), (2, 2, 2), 2, 2, 2, clip_to_bounds=False)
        np.testing.assert_allclose(
            float(v.values[0, 0, 0]), 0.5 + 5.0 + 50.0, atol=1e-5
        )
        np.testing.assert_allclose(
            float(v.values[1, 0, 1]), 1.5 + 5.0 + 150.0, atol=1e-4
        )


class TestVoxelize:
    def test_dims_and_world_size(self):
        # VolumeTests.cs:11-24 semantics.
        v = sk.voxelize(sk.sphere(1.0), (-2, -2, -2), (2, 2, 2), 4, 6, 8)
        assert v.values.shape == (4, 6, 8)
        assert v.colors.shape == (4, 6, 8, 3)
        np.testing.assert_allclose(np.asarray(v.size), [4, 4, 4])
        np.testing.assert_allclose(np.asarray(v.center), [0, 0, 0])

    def test_center_value_sphere(self):
        # VolumeTests.cs:83-106: center cell of odd grid holds -radius.
        v = sk.voxelize(
            sk.sphere(1.0), (-1.5, -1.5, -1.5), (1.5, 1.5, 1.5), 5, 5, 5,
            clip_to_bounds=False,
        )
        np.testing.assert_allclose(float(v.values[2, 2, 2]), -1.0, atol=1e-6)

    def test_colors_sampled(self):
        v = sk.voxelize(
            sk.sphere(1.0, color=(0.3, 0.6, 0.9)), (-1, -1, -1), (1, 1, 1), 3, 3, 3
        )
        np.testing.assert_allclose(
            np.asarray(v.colors[1, 1, 1]), [0.3, 0.6, 0.9], atol=1e-6
        )

    def test_clip_to_bounds_walls(self):
        # Voxels.cs:133-167: walls overwritten with size.x/nx, interior kept.
        n = 5
        v = sk.voxelize(sk.sphere(10.0), (-1, -1, -1), (1, 1, 1), n, n, n)
        outside = 2.0 / n
        vals = np.asarray(v.values)
        np.testing.assert_allclose(vals[0, :, :], outside)
        np.testing.assert_allclose(vals[-1, :, :], outside)
        np.testing.assert_allclose(vals[:, 0, :], outside)
        np.testing.assert_allclose(vals[:, -1, :], outside)
        np.testing.assert_allclose(vals[:, :, 0], outside)
        np.testing.assert_allclose(vals[:, :, -1], outside)
        assert vals[2, 2, 2] < 0  # interior untouched

    def test_unclipped_keeps_walls(self):
        v = sk.voxelize(
            sk.sphere(10.0), (-1, -1, -1), (1, 1, 1), 5, 5, 5, clip_to_bounds=False
        )
        assert float(np.asarray(v.values).max()) < 0

    def test_world_space_indexer(self):
        v = sk.voxelize(
            sk.solid(lambda p: p.x), (-1, -1, -1), (1, 1, 1), 4, 4, 4,
            clip_to_bounds=False,
        )
        # p=(0.3,0,0) falls in cell ix=2 whose center x is 0.25.
        np.testing.assert_allclose(v.value_at((0.3, 0.0, 0.0)), 0.25, atol=1e-6)
