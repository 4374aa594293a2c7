"""Differentiable fitting tests: loss descends, parameters converge toward a
known target, and orbax checkpoint/resume reproduces the uninterrupted run.
"""

import jax.numpy as jnp
import numpy as np

import sdfkit as sk
from sdfkit.fit import fit

W, H = 24, 16


def target_image():
    return np.asarray(sk.render(sk.sphere(1.0, color=(0.8, 0.3, 0.2)), W, H))


def start_sdf():
    return sk.sphere(0.7, color=(0.4, 0.4, 0.4))


class TestFit:
    def test_loss_descends_and_radius_converges(self):
        res = fit(start_sdf(), target_image(), steps=150, learning_rate=0.02)
        assert res.losses[-1] < 0.01 * res.losses[0]
        assert abs(float(res.sdf.radius) - 1.0) < 0.05
        np.testing.assert_allclose(
            np.asarray(res.sdf.rgb), [0.8, 0.3, 0.2], atol=0.05
        )

    def test_fused_backend_descends_like_jnp(self):
        # backend='interpret' routes every step through the forward and
        # backward kernels (in the Pallas interpreter); a few steps must
        # track the jnp path closely.
        tgt = target_image()
        rj = fit(start_sdf(), tgt, steps=5, learning_rate=0.02, backend="jnp")
        rf = fit(start_sdf(), tgt, steps=5, learning_rate=0.02, backend="interpret")
        assert rf.losses[-1] < rf.losses[0]
        np.testing.assert_allclose(rf.losses, rj.losses, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(
            float(rf.sdf.radius), float(rj.sdf.radius), rtol=1e-3
        )

    def test_auto_backend_picks_jnp_on_cpu(self):
        from sdfkit.render.pallas.raymarch_kernel import resolve_backend

        assert resolve_backend("auto", start_sdf()) == "jnp"  # cpu tests
        import pytest

        with pytest.raises(ValueError, match="unknown backend"):
            fit(start_sdf(), target_image(), steps=1, backend="bogus")

    def test_progress_callback(self):
        seen = []
        fit(start_sdf(), target_image(), steps=3, progress=lambda s, l: seen.append(s))
        assert seen == [0, 1, 2]

    def test_checkpoint_resume_matches_uninterrupted(self, tmp_path):
        tgt = target_image()
        full = fit(start_sdf(), tgt, steps=20, learning_rate=0.03)

        ckpt = tmp_path / "ckpt"
        fit(
            start_sdf(), tgt, steps=10, learning_rate=0.03,
            checkpoint_dir=ckpt, checkpoint_every=5,
        )
        resumed = fit(
            start_sdf(), tgt, steps=20, learning_rate=0.03,
            checkpoint_dir=ckpt, checkpoint_every=5,
        )
        assert resumed.resumed_from == 10
        assert resumed.steps_run == 10
        np.testing.assert_allclose(
            float(resumed.sdf.radius), float(full.sdf.radius), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(resumed.sdf.rgb), np.asarray(full.sdf.rgb), atol=1e-5
        )

    def test_fit_csg_tree_params(self):
        # Gradients flow through a CSG tree: fit the translation of one lobe.
        tgt = np.asarray(
            sk.render(
                sk.sphere(0.6).translate(0.5, 0, 0) | sk.sphere(0.6).translate(-0.5, 0, 0),
                W, H,
            )
        )
        s0 = sk.sphere(0.6).translate(0.3, 0, 0) | sk.sphere(0.6).translate(-0.5, 0, 0)
        res = fit(s0, tgt, steps=150, learning_rate=0.01)
        assert res.losses[-1] < 0.6 * res.losses[0]
        # The x offset is the observable direction; y/z are weakly constrained
        # by this view and may drift a little.
        assert abs(float(res.sdf.a.offset[0]) - 0.5) < 0.1


class TestFitSharded:
    """fit(mesh=...) — the full multi-chip loop."""

    def _mesh(self, n=8):
        import jax
        from jax.sharding import Mesh

        return Mesh(np.array(jax.devices()[:n]), axis_names=("rays",))

    def test_matches_single_device(self):
        tgt = target_image()
        single = fit(start_sdf(), tgt, steps=8, learning_rate=0.02,
                     backend="jnp")
        sharded = fit(start_sdf(), tgt, steps=8, learning_rate=0.02,
                      mesh=self._mesh())
        # Same optax chain (clip + adam) on the psum'd gradient: identical
        # trajectory up to reduction-order rounding.
        np.testing.assert_allclose(
            sharded.losses, single.losses, rtol=1e-3, atol=1e-7
        )
        np.testing.assert_allclose(
            float(sharded.sdf.radius), float(single.sdf.radius), rtol=1e-3
        )
        np.testing.assert_allclose(
            np.asarray(sharded.sdf.rgb), np.asarray(single.sdf.rgb), rtol=1e-3
        )

    def test_uneven_rows_and_loss_descends(self):
        # H=16 does not divide 7 devices: the pad-and-mask path must keep the
        # loss identical to the unpadded mean.
        tgt = target_image()
        m = self._mesh(7)
        sharded = fit(start_sdf(), tgt, steps=5, learning_rate=0.02, mesh=m)
        single = fit(start_sdf(), tgt, steps=5, learning_rate=0.02,
                     backend="jnp")
        assert sharded.losses[-1] < sharded.losses[0]
        np.testing.assert_allclose(
            sharded.losses, single.losses, rtol=1e-3, atol=1e-7
        )

    def test_checkpoint_resume_on_mesh(self, tmp_path):
        tgt = target_image()
        m = self._mesh()
        full = fit(start_sdf(), tgt, steps=12, learning_rate=0.03, mesh=m)
        ckpt = tmp_path / "ckpt_mesh"
        fit(start_sdf(), tgt, steps=6, learning_rate=0.03, mesh=m,
            checkpoint_dir=ckpt, checkpoint_every=3)
        resumed = fit(start_sdf(), tgt, steps=12, learning_rate=0.03, mesh=m,
                      checkpoint_dir=ckpt, checkpoint_every=3)
        assert resumed.resumed_from == 6
        np.testing.assert_allclose(
            float(resumed.sdf.radius), float(full.sdf.radius), atol=1e-5
        )


class TestFitIndexedPalette:
    """fit() optimizing a RepeatIndexedColor palette:
    the per-cell color table is a data leaf, so the image loss drives the
    palette itself — impossible through the static color_fn closures."""

    def _scene(self, table):
        return sk.sphere(0.55).repeat_indexed("xy", (1.25, 1.25), table)

    def test_palette_converges_to_target(self):
        import jax
        import optax

        target_table = jnp.asarray([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]])
        tgt = np.asarray(sk.render(self._scene(target_table), W, H))
        start = self._scene(jnp.full((2, 3), 0.5))
        # Optimize ONLY the palette (geometry already matches the target);
        # label-routed optax works because the sdf is an ordinary pytree.
        # NOTE: param_labels must be a callable here — a labels pytree built
        # by tree_map over an SdfExpr IS an SdfExpr, which optax would call.
        res = fit(
            start, tgt, steps=120,
            optimizer=optax.multi_transform(
                {"table": optax.adam(0.05), "frozen": optax.set_to_zero()},
                lambda params: jax.tree_util.tree_map(
                    lambda l: "table" if np.shape(l) == (2, 3) else "frozen",
                    params,
                ),
            ),
        )
        assert res.losses[-1] < 0.05 * res.losses[0]
        np.testing.assert_allclose(
            np.asarray(res.sdf.table), np.asarray(target_table), atol=0.1
        )

    def test_fused_backend_handles_table_leaf(self):
        target_table = jnp.asarray([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]])
        tgt = np.asarray(sk.render(self._scene(target_table), W, H))
        start = self._scene(jnp.full((2, 3), 0.5))
        rj = fit(start, tgt, steps=4, learning_rate=0.03, backend="jnp")
        rf = fit(start, tgt, steps=4, learning_rate=0.03, backend="interpret")
        # The repeated-sphere frame is mostly silhouette pixels, where the
        # kernel's rounding drifts from the jnp path and compounds through
        # the optimizer steps (see tests/test_goldens.py) — hence the looser
        # bound than the single-sphere fused-vs-jnp test above.
        np.testing.assert_allclose(rf.losses, rj.losses, rtol=3e-2, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(rf.sdf.table), np.asarray(rj.sdf.table),
            rtol=3e-2, atol=1e-3,
        )
