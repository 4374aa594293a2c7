"""Image-writer tests (reference parity: Tests/VectorTests.cs — TGA writers
produce valid images; here verified by byte-level round-trip instead of
eyeballing artifacts).
"""

import numpy as np
import pytest

import sdfkit as sk
from sdfkit.io.tga import read_tga, write_depth_tga, write_tga


class TestTga:
    def test_rgb_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 1, size=(12, 17, 3)).astype(np.float32)
        p = tmp_path / "img.tga"
        write_tga(p, img)
        back = read_tga(p)
        assert back.shape == (12, 17, 3)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_rgb_clips_out_of_range(self, tmp_path):
        img = np.array([[[-0.5, 0.5, 1.5]]], np.float32)
        p = tmp_path / "clip.tga"
        write_tga(p, img)
        np.testing.assert_allclose(read_tga(p)[0, 0], [0.0, 0.5, 1.0], atol=1 / 255)

    def test_depth_near_white_far_black(self, tmp_path):
        # Reference maps near depths bright, far depths dark
        # (FloatData.SaveDepthTga, VectorData.cs:244-276).
        depth = np.array([[1.0, 50.0, 100.0, 1e6]], np.float32)
        p = tmp_path / "depth.tga"
        write_depth_tga(p, depth, near=1.0, far=100.0)
        gray = read_tga(p)[0, :, 0]
        assert gray[0] == 1.0  # near plane -> white
        assert gray[0] > gray[1] > gray[2]  # monotone toward far
        assert gray[3] == 0.0  # misses past far -> black

    def test_rendered_image_writes(self, tmp_path):
        img = np.asarray(sk.render(sk.sphere(1.0), 16, 8))
        p = tmp_path / "render.tga"
        write_tga(p, img)
        back = read_tga(p)
        assert back.shape == (8, 16, 3)
        # Sky pixels survive the round trip (corner ray misses the sphere).
        np.testing.assert_allclose(back[0, 0], [0.5, 0.75, 1.0], atol=1 / 255)


class TestPng:
    def test_rgb_roundtrip(self, tmp_path):
        from sdfkit.io.png import read_png, write_png

        rng = np.random.default_rng(1)
        img = rng.uniform(0, 1, size=(9, 21, 3)).astype(np.float32)
        p = tmp_path / "rt.png"
        write_png(p, img)
        back = read_png(p)
        assert back.shape == (9, 21, 3)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_grayscale_roundtrip(self, tmp_path):
        from sdfkit.io.png import read_png, write_png

        img = np.linspace(0, 1, 24, dtype=np.float32).reshape(4, 6)
        p = tmp_path / "gray.png"
        write_png(p, img)
        back = read_png(p)
        assert back.shape == (4, 6)
        np.testing.assert_allclose(back, img, atol=1.0 / 255.0)

    def test_depth_mapping_matches_tga(self, tmp_path):
        from sdfkit.io.png import read_png, write_depth_png

        depth = np.array([[1.0, 50.0, 100.0, 1e6]], np.float32)
        p = tmp_path / "depth.png"
        write_depth_png(p, depth, near=1.0, far=100.0)
        gray = read_png(p)[0]
        assert gray[0] == 1.0 and gray[3] == 0.0
        assert gray[0] > gray[1] > gray[2]

    def test_readable_by_pil(self, tmp_path):
        from sdfkit.io.png import write_png

        PIL = pytest.importorskip("PIL.Image")
        img = np.asarray(sk.render(sk.sphere(1.0), 16, 8))
        p = tmp_path / "render.png"
        write_png(p, img)
        with PIL.open(p) as im:
            assert im.size == (16, 8) and im.mode == "RGB"


class TestVoxelsPersistence:
    def test_save_load_roundtrip(self, tmp_path):
        s = sk.sphere(0.8, color=(0.9, 0.2, 0.1))
        vox = s.to_voxels((-1, -1, -1), (1, 1, 1), 8, 8, 8)
        p = tmp_path / "vol.npz"
        vox.save(p)
        back = sk.Voxels.load(p)
        np.testing.assert_array_equal(np.asarray(back.values), np.asarray(vox.values))
        np.testing.assert_array_equal(np.asarray(back.colors), np.asarray(vox.colors))
        np.testing.assert_array_equal(np.asarray(back.vmin), np.asarray(vox.vmin))
        # Meshing the loaded volume works identically.
        m1, m2 = vox.to_mesh(), back.to_mesh()
        assert len(m1.vertices) == len(m2.vertices) > 0


class TestTgaOrientation:
    """The reference's VectorTests.BlackOnTop/RedOnTop analogues: row order
    must survive into the FILE as an external decoder sees it (our own
    read_tga would hide a mutual y-flip)."""

    def test_red_on_top_external_decoder(self, tmp_path):
        from PIL import Image

        img = np.zeros((20, 30, 3), np.float32)
        img[:10] = [1.0, 0.0, 0.0]   # top half red
        img[10:] = [0.0, 1.0, 0.0]   # bottom half green
        p = tmp_path / "red_on_top.tga"
        write_tga(p, img)
        decoded = np.asarray(Image.open(p).convert("RGB"))
        np.testing.assert_array_equal(decoded[0], [[255, 0, 0]] * 30)
        np.testing.assert_array_equal(decoded[-1], [[0, 255, 0]] * 30)

    def test_black_on_top_depth_external_decoder(self, tmp_path):
        from PIL import Image

        near, far = 0.0, 1.0
        depth = np.zeros((20, 30), np.float32)
        depth[:10] = far    # top half far -> black
        depth[10:] = near   # bottom half near -> white
        p = tmp_path / "black_on_top.tga"
        write_depth_tga(p, depth, near=near, far=far)
        decoded = np.asarray(Image.open(p).convert("RGB"))
        assert decoded[0].max() == 0       # far = black on top
        assert decoded[-1].min() == 255    # near = white at bottom
