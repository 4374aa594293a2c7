"""Camera matrices and rays against a float64 numpy reference."""

import numpy as np
import pytest

import sdfkit as sk
from sdfkit.utils.camera import camera_rays, perspective_fov


def _np_look_at(eye, target, up):
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = eye - target
    z /= np.linalg.norm(z)
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
    m[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    return m


def _np_rays(width, height, view, vfov_deg=60.0, near=1.0, far=100.0):
    view = np.asarray(view, np.float64)
    cam = np.linalg.inv(view)[3, :3]
    ys = 1.0 / np.tan(np.deg2rad(vfov_deg) / 2)
    proj = np.zeros((4, 4))
    proj[0, 0] = ys / (width / height)
    proj[1, 1] = ys
    proj[2, 2] = far / (near - far)
    proj[2, 3] = -1.0
    proj[3, 2] = near * far / (near - far)
    ivp = np.linalg.inv(view @ proj)
    xs = -1.0 + 2.0 * np.arange(width) / max(width - 1, 1)
    yv = 1.0 - 2.0 * np.arange(height) / max(height - 1, 1)
    x, y = np.meshgrid(xs, yv)
    h = (x[..., None] * ivp[0] + y[..., None] * ivp[1] + ivp[3])
    pos = h[..., :3] / h[..., 3:]
    d = pos - cam
    return cam, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("eye", [(0.0, 0.0, 5.0), (-2.0, 2.0, 4.0),
                                 (3.0, -1.0, 2.5)])
def test_look_at_matches_float64(eye):
    got = np.asarray(sk.look_at(eye, (0, 0, 0), (0, 1, 0)), np.float64)
    np.testing.assert_allclose(got, _np_look_at(eye, (0, 0, 0), (0, 1, 0)),
                               atol=1e-6)


@pytest.mark.parametrize("width, height", [(64, 36), (17, 13)])
def test_camera_rays_match_float64(width, height):
    view = sk.look_at((-2.0, 2.0, 4.0), (0, 0, 0), (0, 1, 0))
    ro, rd = camera_rays(width, height, view)
    cam, d = _np_rays(width, height, np.asarray(view, np.float64))
    for comp, k in zip((ro.x, ro.y, ro.z), range(3)):
        np.testing.assert_allclose(np.asarray(comp), cam[k], atol=1e-6)
    got = np.stack([np.asarray(c) for c in (rd.x, rd.y, rd.z)], axis=-1)
    np.testing.assert_allclose(got, d, atol=1e-6)


def test_perspective_matches_float64():
    got = np.asarray(perspective_fov(np.deg2rad(60.0), 16 / 9, 1.0, 100.0))
    ys = 1.0 / np.tan(np.deg2rad(60.0) / 2)
    assert abs(got[1, 1] - ys) < 1e-6 and abs(got[0, 0] - ys * 9 / 16) < 1e-6
    assert got[2, 3] == -1.0
