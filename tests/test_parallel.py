"""Multi-device sharding tests (8 virtual CPU devices, see conftest.py).

Sharded rendering must match single-device execution. The march itself is
deterministic (disjoint ray tiles, no collectives — the analogue of the
reference's disjoint Parallel.For slices, SURVEY.md section 5), but XLA
compiles the full image and the per-shard block as different computations,
and its shape-dependent FMA contraction changes the rounding of
``ro + rd * depth``; 40 march iterations compound those ulps. So render
comparisons use tolerances (relative for depth — miss rays legitimately
accumulate depths ~1e6); the voxelize path is a single SDF sweep and stays
bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import sdfkit as sk
from sdfkit.parallel.train import (
    render_sharded,
    train_step_sharded,
    voxelize_sharded,
)


@pytest.fixture(scope="module")
def mesh():
    devices = np.array(jax.devices()[:8])
    return Mesh(devices, axis_names=("rays",))


def scene():
    return sk.sphere(0.5, color=(0.9, 0.5, 0.2)).repeat_xy(1.5, 1.5) | sk.box(
        0.25
    ).translate(0, 0, -2)


class TestRenderSharded:
    def test_matches_single_device(self, mesh):
        s = scene()
        img1 = np.asarray(sk.render(s, 32, 16))
        img8 = np.asarray(render_sharded(mesh, s, 32, 16))
        # Colors live in [0, ~1.1]; 0.02 absorbs the ulp drift amplified by
        # the 1e-5 central-difference normals without hiding real bugs.
        np.testing.assert_allclose(img1, img8, atol=2e-2)

    def test_depth_matches(self, mesh):
        s = scene()
        d1 = np.asarray(sk.render_depth(s, 32, 16))
        d8 = np.asarray(render_sharded(mesh, s, 32, 16, depth_only=True))
        np.testing.assert_allclose(d1, d8, rtol=1e-3)

    def test_indivisible_height_pads_and_matches(self, mesh):
        # 15 rows over 8 devices: padded to 16, sliced back (the reference
        # partitions uneven row bands without complaint, RayMarcher.cs:50-61).
        s = scene()
        img1 = np.asarray(sk.render(s, 32, 15))
        img8 = np.asarray(render_sharded(mesh, s, 32, 15))
        assert img8.shape == (15, 32, 3)
        np.testing.assert_allclose(img1, img8, atol=2e-2)


class TestVoxelizeSharded:
    def test_matches_single_device(self, mesh):
        s = scene()
        v1 = sk.voxelize(s, (-1, -1, -1), (1, 1, 1), 16, 8, 8)
        v8 = voxelize_sharded(mesh, s, (-1, -1, -1), (1, 1, 1), 16, 8, 8)
        np.testing.assert_array_equal(np.asarray(v1.values), np.asarray(v8.values))
        np.testing.assert_array_equal(np.asarray(v1.colors), np.asarray(v8.colors))

    def test_indivisible_nx_pads_and_matches(self, mesh):
        # Odd extents change XLA's shape-dependent FMA contraction, so the
        # bit-exact guarantee (held for divisible shapes above) relaxes to a
        # one-ulp tolerance here.
        s = scene()
        v1 = sk.voxelize(s, (-1, -1, -1), (1, 1, 1), 13, 8, 8)
        v8 = voxelize_sharded(mesh, s, (-1, -1, -1), (1, 1, 1), 13, 8, 8)
        assert np.asarray(v8.values).shape == (13, 8, 8)
        np.testing.assert_allclose(
            np.asarray(v1.values), np.asarray(v8.values), atol=2e-7
        )
        np.testing.assert_allclose(
            np.asarray(v1.colors), np.asarray(v8.colors), atol=2e-7
        )


class TestMeshSharded:
    """Sharded marching-cubes dense phase: z-bricks + step-layer ppermute
    halo exchange (parallel/marching.py). The sparse phase is shared with
    the single-device path, so the mesh must be BIT-identical for any device
    count — the meshing determinism guarantee SURVEY §5 asks for."""

    def _assert_same_mesh(self, a, b):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.colors, b.colors)
        np.testing.assert_array_equal(a.normals, b.normals)
        np.testing.assert_array_equal(a.triangles, b.triangles)

    def test_bit_identical_across_device_counts(self, mesh):
        from sdfkit.parallel.marching import create_mesh_sharded

        s = scene()
        v = sk.voxelize(s, (-1.2, -1.2, -1.2), (1.2, 1.2, 1.2), 24, 24, 24)
        m1 = v.to_mesh()
        assert len(m1.vertices) > 0
        for count in (1, 2, 8):
            sub = Mesh(np.array(jax.devices()[:count]), axis_names=("rays",))
            m_n = create_mesh_sharded(sub, v)
            self._assert_same_mesh(m1, m_n)

    def test_golden_sphere_count(self, mesh):
        # The reference golden: sphere r=0.5 in 32^3 => 1248 vertices
        # (Tests/SdfTests.cs:29-39) must survive brick seams and halos.
        from sdfkit.parallel.marching import create_mesh_sharded

        v = sk.voxelize(sk.sphere(0.5), (-1, -1, -1), (1, 1, 1), 32, 32, 32)
        m = create_mesh_sharded(mesh, v)
        assert len(m.vertices) == 1248

    def test_uneven_extent_and_step2(self, mesh):
        # nz=21 with step=2: bricks cover uneven cell counts and the last
        # brick needs the host-supplied tail halo.
        from sdfkit.parallel.marching import create_mesh_sharded

        v = sk.voxelize(sk.sphere(2.0), (-2.5,) * 3, (2.5,) * 3, 21, 21, 21)
        m1 = v.to_mesh(step=2)
        m8 = create_mesh_sharded(mesh, v, step=2)
        assert len(m1.vertices) > 0
        self._assert_same_mesh(m1, m8)

    def test_progress_and_empty(self, mesh):
        from sdfkit.parallel.marching import create_mesh_sharded

        v = sk.voxelize(sk.sphere(0.1), (1, 1, 1), (2, 2, 2), 8, 8, 8)
        seen = []
        m = create_mesh_sharded(mesh, v, progress=seen.append)
        assert len(m.vertices) == 0
        assert seen[0] == 0.0 and seen[-1] == 1.0


class TestTrainStepSharded:
    def test_step_reduces_loss(self, mesh):
        s = sk.sphere(1.0, color=(0.5, 0.5, 0.5))
        target = jnp.zeros((16, 24, 3), jnp.float32)
        s1, l1 = train_step_sharded(mesh, s, target, lr=0.05)
        s2, l2 = train_step_sharded(mesh, s1, target, lr=0.05)
        assert np.isfinite(float(l1)) and np.isfinite(float(l2))
        assert float(l2) < float(l1)

    def test_indivisible_height_matches_single_device(self, mesh):
        # Padded rows must not leak into the loss or the gradients.
        s = sk.sphere(1.0, color=(0.5, 0.5, 0.5))
        target = jnp.zeros((15, 24, 3), jnp.float32)
        single = Mesh(np.array(jax.devices()[:1]), axis_names=("rays",))
        s_multi, l_multi = train_step_sharded(mesh, s, target, lr=0.05)
        s_single, l_single = train_step_sharded(single, s, target, lr=0.05)
        np.testing.assert_allclose(float(l_multi), float(l_single), rtol=1e-5)
        for a, b in zip(
            jax.tree_util.tree_leaves(s_multi), jax.tree_util.tree_leaves(s_single)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)

    def test_grads_replicated_consistently(self, mesh):
        # The updated params must be identical to a single-device update.
        s = sk.sphere(1.0, color=(0.5, 0.5, 0.5))
        target = jnp.zeros((16, 24, 3), jnp.float32)

        single = Mesh(np.array(jax.devices()[:1]), axis_names=("rays",))
        s_multi, _ = train_step_sharded(mesh, s, target, lr=0.05)
        s_single, _ = train_step_sharded(single, s, target, lr=0.05)
        for a, b in zip(
            jax.tree_util.tree_leaves(s_multi), jax.tree_util.tree_leaves(s_single)
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


class TestShardedPipeline:
    """scene -> voxelize_sharded -> create_mesh_sharded composes on ONE grid
    axis (z for both stages), so the multi-chip pipeline runs with no
    implicit full-grid reshard between stages."""

    def test_voxels_stay_z_sharded(self, mesh):
        v = voxelize_sharded(mesh, scene(), (-1, -1, -1), (1, 1, 1), 16, 16, 16)
        assert isinstance(v.values, jax.Array)
        shard_shapes = {s.data.shape for s in v.values.addressable_shards}
        # 8 devices, 16 z layers -> every shard holds a (16, 16, 2) z-brick.
        assert shard_shapes == {(16, 16, 2)}

    def test_composed_bit_identical_to_single_device(self, mesh):
        s = scene()
        v1 = sk.voxelize(s, (-1, -1, -1), (1, 1, 1), 24, 24, 24)
        m1 = v1.to_mesh()
        from sdfkit.parallel.marching import create_mesh_sharded

        v8 = voxelize_sharded(mesh, s, (-1, -1, -1), (1, 1, 1), 24, 24, 24)
        np.testing.assert_array_equal(
            np.asarray(v8.values), np.asarray(v1.values)
        )
        m8 = create_mesh_sharded(mesh, v8)
        np.testing.assert_array_equal(m8.vertices, m1.vertices)
        np.testing.assert_array_equal(m8.colors, m1.colors)
        np.testing.assert_array_equal(m8.normals, m1.normals)
        np.testing.assert_array_equal(m8.triangles, m1.triangles)


class TestFusedSharded:
    """The fused kernel as the shard_map per-band renderer
    (raymarch_kernel.render_rows_fused; backend='interpret' on the CPU).
    All comparisons use the module's standard cross-program tolerances:
    interpret-mode pallas_call is itself traced and XLA-compiled, so the
    sharded band program and the whole-frame program round differently
    (FMA contraction is shape-dependent) and 40 march steps compound the
    ulps — the same effect the jnp sharded tests document above."""

    def test_render_close_to_fused_single_device(self, mesh):
        from sdfkit.render.raymarch import RayMarcher

        s = scene()
        img_1 = np.asarray(RayMarcher(32, 16, s, backend="interpret").render())
        img_f = np.asarray(render_sharded(mesh, s, 32, 16, backend="interpret"))
        np.testing.assert_allclose(img_1, img_f, atol=2e-2)

    def test_render_close_to_jnp_backend(self, mesh):
        s = scene()
        img_j = np.asarray(render_sharded(mesh, s, 32, 16, backend="jnp"))
        img_f = np.asarray(render_sharded(mesh, s, 32, 16, backend="interpret"))
        np.testing.assert_allclose(img_j, img_f, atol=2e-2)

    def test_depth_and_uneven_height(self, mesh):
        from sdfkit.render.raymarch import RayMarcher

        s = scene()
        d_1 = np.asarray(
            RayMarcher(32, 15, s, backend="interpret").render_depth()
        )
        d_f = np.asarray(
            render_sharded(mesh, s, 32, 15, depth_only=True, backend="interpret")
        )
        assert d_f.shape == (15, 32)
        np.testing.assert_allclose(d_1, d_f, rtol=1e-3)

    def test_train_step_matches_jnp_backend(self, mesh):
        from sdfkit.parallel.train import train_step_sharded

        s = scene()
        target = jnp.zeros((16, 32, 3), jnp.float32)
        s_j, l_j = train_step_sharded(mesh, s, target, backend="jnp")
        s_f, l_f = train_step_sharded(mesh, s, target, backend="interpret")
        np.testing.assert_allclose(float(l_j), float(l_f), rtol=1e-3)
        for a, b in zip(
            jax.tree_util.tree_leaves(s_j), jax.tree_util.tree_leaves(s_f)
        ):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-4
            )

    def test_fit_mesh_fused_runs(self, mesh):
        import sdfkit as sk2

        s = sk2.sphere(0.4, color=(0.8, 0.2, 0.2))
        target = np.asarray(sk2.render(sk2.sphere(0.55), 24, 16))
        res = sk2.fit(s, target, steps=2, mesh=mesh, backend="interpret")
        assert len(res.losses) == 2
        assert res.losses[1] <= res.losses[0] * 1.5  # moving, not exploding

    def test_elastic_tiles_fused_matches_fused_whole_frame(self, mesh,
                                                           tmp_path):
        from sdfkit.parallel.elastic import render_tiles_resumable
        from sdfkit.render.raymarch import RayMarcher

        s = scene()
        img_1 = np.asarray(RayMarcher(32, 16, s, backend="interpret").render())
        img_f, stats = render_tiles_resumable(
            s, 32, 16, tmp_path / "f", tile_rows=8, mesh=mesh,
            backend="interpret",
        )
        assert stats["rendered"] == 2
        np.testing.assert_allclose(img_1, img_f, atol=2e-2)


class TestIndexedPaletteSharded:
    def test_elastic_tiles_with_palette_scene(self, mesh, tmp_path):
        # The (T, 3) palette data leaf must survive the elastic fused tile
        # path's param flattening under shard_map exactly like the plain
        # scene tree does.
        import jax.numpy as jnp

        from sdfkit.parallel.elastic import render_tiles_resumable
        from sdfkit.render.raymarch import RayMarcher

        s = sk.sphere(0.5).repeat_indexed(
            "xy", (1.125, 1.125),
            jnp.asarray([[0.9, 0.2, 0.2], [0.2, 0.9, 0.2]]),
        )
        img_1 = np.asarray(RayMarcher(32, 16, s, backend="interpret").render())
        img_f, stats = render_tiles_resumable(
            s, 32, 16, tmp_path / "pal", tile_rows=8, mesh=mesh,
            backend="interpret",
        )
        assert stats["rendered"] == 2
        np.testing.assert_allclose(img_1, img_f, atol=2e-2)
