"""The compiled GPU kernels against the plain reference. These need the
card: run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

On any other platform the ``gpu`` fixture skips them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sdfkit as sk
from bench import sphere_repeat_scene
from chip_smoke import image_agreement, reference_render
from sdfkit.render.pallas import raymarch_kernel as rk
from sdfkit.render.raymarch import RenderConfig, render_depth_rays
from sdfkit.utils.camera import camera_rays

pytestmark = pytest.mark.gpu

VIEW = ((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def test_auto_picks_the_kernels(gpu):
    assert rk.resolve_backend("auto", sphere_repeat_scene()) == "fused"


@pytest.mark.parametrize("width, height", [(192, 108), (97, 61)])
def test_fused_render_matches_reference(gpu, width, height):
    view = sk.look_at(*VIEW)
    img = np.asarray(sk.render(sphere_repeat_scene(), width, height,
                               view=view, backend="fused"))
    ref = reference_render(sphere_repeat_scene(), width, height, view)
    assert image_agreement(img, ref)["ok"]


def test_fused_depth_grads_match_reference(gpu):
    s = sk.sphere(0.8) | sk.box(0.4).translate(1.0, 0.0, 0.0)
    view = sk.look_at(*VIEW)
    cfg = RenderConfig(width=64, height=36)

    def masked(d):
        return jnp.sum(jnp.where(d < 50.0, d, 0.0))

    def loss_ref(s):
        ro, rd = camera_rays(64, 36, view, cfg.vfov_degrees, cfg.near,
                             cfg.far)
        return masked(render_depth_rays(s, ro, rd, cfg))

    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(loss_ref)(s)
    g = jax.grad(lambda s: masked(rk.render_depth_image_fused(s, view, cfg)))(s)
    for a, b in zip(jax.tree_util.tree_leaves(g),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-3,
                                   atol=1e-4)
