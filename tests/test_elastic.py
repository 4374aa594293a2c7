"""Restartable tile rendering (parallel/elastic.py) — SURVEY §5 failure
detection / elastic recovery: render jobs restartable at the ray-tile level,
resumed runs bit-identical to uninterrupted ones."""

import numpy as np
import pytest
import jax
from jax.sharding import Mesh

import sdfkit as sk
from sdfkit.parallel.elastic import render_tiles_resumable


def scene():
    return sk.sphere(1.0, color=(0.8, 0.4, 0.2)) | sk.box(0.5).translate(1.2, 0, 0)


class TestElasticRender:
    def test_resume_bit_identical(self, tmp_path):
        full_dir = tmp_path / "full"
        img_full, stats = render_tiles_resumable(
            scene(), 64, 48, full_dir, tile_rows=16)
        assert stats == {"resumed": 0, "rendered": 3, "tiles": 3}

        # Simulated crash after 2 of 3 tiles: a progress callback raises.
        crash_dir = tmp_path / "crash"
        class Boom(Exception):
            pass
        def crash_after_2(done, total):
            if done == 2:
                raise Boom()
        with pytest.raises(Boom):
            render_tiles_resumable(scene(), 64, 48, crash_dir, tile_rows=16,
                                   progress=crash_after_2)
        # Restart: resumes the 2 surviving tiles, renders the last one.
        img, stats = render_tiles_resumable(scene(), 64, 48, crash_dir,
                                            tile_rows=16)
        assert stats == {"resumed": 2, "rendered": 1, "tiles": 3}
        np.testing.assert_array_equal(img, img_full)

    def test_manifest_mismatch_rejected(self, tmp_path):
        d = tmp_path / "job"
        render_tiles_resumable(scene(), 32, 16, d, tile_rows=8)
        with pytest.raises(ValueError, match="manifest mismatch"):
            render_tiles_resumable(scene(), 32, 32, d, tile_rows=8)

    def test_sharded_tiles_match_single(self, tmp_path):
        img1, _ = render_tiles_resumable(scene(), 32, 24, tmp_path / "a",
                                         tile_rows=8)
        mesh = Mesh(np.array(jax.devices()[:8]), ("rays",))
        img8, _ = render_tiles_resumable(scene(), 32, 24, tmp_path / "b",
                                         tile_rows=8, mesh=mesh)
        np.testing.assert_allclose(img8, img1, atol=2e-2)
