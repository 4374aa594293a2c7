"""Batch sampling driver tests (reference: SdfEx.Sample, Sdf.cs:22-47;
Tests/VolumeTests.cs batch-boundary tests and Tests/SdfTests.cs goldens).
"""

import jax.numpy as jnp
import numpy as np

import sdfkit as sk


def rng_points(n, seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, size=(n, 3)).astype(np.float32)


class TestSample:
    def test_matches_direct_call(self):
        s = sk.sphere(0.7, color=(0.2, 0.4, 0.8))
        pts = rng_points(300)
        np.testing.assert_allclose(
            np.asarray(sk.sample(s, pts, batch_size=70)),
            np.asarray(s(pts)),
            atol=1e-6,
        )

    def test_remainder_batch(self):
        # 300 points / 70 = 4 full batches + a 20-point remainder; the
        # remainder must come back exact, not padded (Sdf.cs:29-31).
        s = sk.solid(lambda p: p.x)
        pts = rng_points(300, seed=1)
        out = np.asarray(sk.sample(s, pts, batch_size=70))
        assert out.shape == (300, 4)
        np.testing.assert_allclose(out[:, 3], pts[:, 0], atol=1e-6)

    def test_batch_shape_seen_by_sdf(self):
        # SDF-as-spy, lifted to trace time: under lax.map the SDF must be
        # traced with exactly (batch_size,) components — the device analogue of
        # VolumeTests' assertion that every batch has length 70
        # (VolumeTests.cs:109-135).
        seen = []

        def probe(p):
            seen.append(p.x.shape)
            return p.length() - 1.0

        _ = sk.sample(sk.solid(probe), rng_points(300, seed=2), batch_size=70)
        assert seen == [(70,)]

    def test_batch_larger_than_n(self):
        s = sk.sphere(1.0)
        pts = rng_points(5, seed=3)
        out = np.asarray(sk.sample(s, pts, batch_size=2048))
        np.testing.assert_allclose(
            out[:, 3], np.linalg.norm(pts, axis=1) - 1.0, atol=1e-5
        )

    def test_method_form(self):
        s = sk.sphere(1.0)
        pts = rng_points(10, seed=4)
        np.testing.assert_allclose(
            np.asarray(s.sample(pts)), np.asarray(sk.sample(s, pts)), atol=0
        )

    def test_rejects_bad_shape(self):
        import pytest

        with pytest.raises(ValueError):
            sk.sample(sk.sphere(1.0), np.zeros((4, 2), np.float32))


class TestSdfTestsGoldens:
    """Golden values from the reference's Tests/SdfTests.cs."""

    def test_volume_sphere_128(self):
        # CreateVolumeSphere (SdfTests.cs:11-26): raw batched callable tier,
        # 128^3 over [-1,1]^3, v[63,63,63] == -0.5 +- 2e-2.
        r = 0.5
        v = sk.voxelize(sk.sphere(r), (-1, -1, -1), (1, 1, 1), 128, 128, 128)
        assert abs(float(v.values[63, 63, 63]) + r) < 2e-2

    def test_mesh_sphere_1248_primitive_tier(self):
        # CreateMeshSphere (SdfTests.cs:28-38): Sdfs.Sphere tier.
        m = sk.sphere(0.5).to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        assert len(m.vertices) == 1248

    def test_mesh_sphere_1248_solid_expr_tier(self):
        # SolidSphere (SdfTests.cs:40-51): compiled-expression tier. The two
        # tiers must agree exactly (tier-equivalence proof).
        s = sk.solid(lambda p: p.length() - 0.5)
        m = s.to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        assert len(m.vertices) == 1248
