"""The one renderer-backend rule and the kernel wrappers' plumbing
(parameter packing, padding, row bands), checked without a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdfkit as sk
from sdfkit.render.pallas import raymarch_kernel as rk
from sdfkit.render.raymarch import RenderConfig
from sdfkit.utils.v3 import V3, ScalarArray


def _spheres(n: int):
    """Union of n spheres: 4 parameter scalars each."""
    return sk.union(*[sk.sphere(1.0 + 0.1 * i) for i in range(n)])


SMALL = _spheres(1)
LARGE = _spheres(rk.MAX_FUSED_PARAM_SCALARS // 4 + 1)


@pytest.mark.parametrize(
    "backend, platform, scene, expected",
    [
        ("auto", "gpu", SMALL, "fused"),
        ("auto", "gpu", LARGE, "jnp"),
        ("auto", "cpu", SMALL, "jnp"),
        ("fused", "gpu", SMALL, "fused"),
        ("interpret", "cpu", SMALL, "interpret"),
        ("interpret", "gpu", SMALL, "interpret"),
        ("jnp", "gpu", SMALL, "jnp"),
        ("jnp", "cpu", LARGE, "jnp"),
    ],
)
def test_resolve_backend(backend, platform, scene, expected):
    assert rk.resolve_backend(backend, scene, platform) == expected


@pytest.mark.parametrize(
    "backend, platform, scene, match",
    [
        ("fused", "cpu", SMALL, "backend='interpret'"),
        ("fused", "gpu", LARGE, "backend='jnp'"),
        ("interpret", "cpu", LARGE, "backend='jnp'"),
        ("bogus", "gpu", SMALL, "unknown backend"),
    ],
)
def test_resolve_backend_refuses(backend, platform, scene, match):
    with pytest.raises(ValueError, match=match):
        rk.resolve_backend(backend, scene, platform)


def test_param_count_at_the_cap():
    assert rk.param_count(SMALL) == 4
    assert rk.param_count(LARGE) == rk.MAX_FUSED_PARAM_SCALARS + 4


def test_default_platform_is_the_default_backend():
    # These tests run on the CPU: 'auto' must keep the jnp path there.
    assert rk.resolve_backend("auto", SMALL) == "jnp"


def test_scalar_array_indexes_without_slicing():
    items = np.empty((2, 3), dtype=object)
    for i in range(6):
        items.flat[i] = float(i)
    a = ScalarArray(items)
    assert a.shape == (2, 3) and a.ndim == 2
    assert a[1, 2] == 5.0
    assert isinstance(a[1], ScalarArray) and a[1][0] == 3.0
    v = V3.splat(a[0])
    assert (v.x, v.y, v.z) == (0.0, 1.0, 2.0)


def test_pack_and_rebuild_round_trip():
    s = sk.sphere(0.7, color=(0.1, 0.2, 0.3)).translate(1.0, 2.0, 3.0)
    flat, meta = rk._pack_params(s)
    # Leaves concatenated in pytree order, plus one pad element.
    assert flat.shape == (rk.param_count(s) + 1,)
    rebuilt = rk._rebuild(meta, [float(x) for x in np.asarray(flat)])
    p = V3(jnp.zeros(4), jnp.ones(4), jnp.full(4, 2.0))
    np.testing.assert_allclose(
        np.asarray(rebuilt.distance(p)), np.asarray(s.distance(p)), rtol=1e-6
    )
    g = rk._unpack_grads(meta, flat)
    for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(s)):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("width, height", [(8, 4), (17, 13), (32, 16)])
def test_forward_pads_to_whole_blocks(width, height):
    cfg = RenderConfig(width=width, height=height, depth_iterations=4)
    s = sk.sphere(1.0)
    flat, meta = rk._pack_params(s)
    view = rk.view_to_kernel_view(sk.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                                  cfg)
    out = rk._forward(
        flat, view, jnp.zeros((1,), jnp.int32), meta=meta, cfg=cfg,
        want_color=True, local_npix=width * height, interpret=True,
        block=rk.BLOCK, num_warps=rk.NUM_WARPS,
    )
    padded = -(-width * height // rk.BLOCK) * rk.BLOCK
    assert [o.shape for o in out] == [(padded,)] * 3
    img = rk.render_image_fused(s, sk.look_at((0, 0, 5), (0, 0, 0),
                                              (0, 1, 0)), cfg, True)
    assert img.shape == (height, width, 3)


def test_row_bands_tile_the_whole_image():
    # Rendering the image as two row bands at traced pixel offsets gives
    # the whole-image render exactly: rays come from the global pixel index.
    cfg = RenderConfig(width=12, height=10, depth_iterations=6)
    s = sk.sphere(1.0, color=(0.9, 0.4, 0.2))
    view = sk.look_at((0.5, 0.2, 5.0), (0, 0, 0), (0, 1, 0))
    kview = rk.view_to_kernel_view(view, cfg)
    whole = rk.render_image_fused(s, view, cfg, True)
    bands = [
        rk.render_rows_fused(s, kview, jnp.int32(r0 * cfg.width), cfg, 5,
                             True)
        for r0 in (0, 5)
    ]
    np.testing.assert_array_equal(np.concatenate(bands), np.asarray(whole))
    depth = rk.render_rows_fused(s, kview, 0, cfg, 10, True, depth_only=True)
    assert depth.shape == (10, 12)


def test_backward_partials_are_deterministic():
    # The backward writes per-program partial rows that XLA sums: the same
    # call twice gives bit-identical gradients.
    cfg = RenderConfig(width=24, height=16, depth_iterations=6)
    view = sk.look_at((-2.0, 2.0, 4.0), (0, 0, 0), (0, 1, 0))

    def loss(s):
        return jnp.sum(rk.render_image_fused(s, view, cfg, True))

    g1 = jax.grad(loss)(sk.sphere(0.9))
    g2 = jax.grad(loss)(sk.sphere(0.9))
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
