"""The port's interactive camera operations (``Camera.scale_fov``,
``orbit``, ``translate``, ``dolly``) against the JAX package's on the same
cameras, and ``tests/test_camera.py:92``'s checks. Both build the new
camera in float64 on the host and store float32: rtol 1e-6."""
import numpy as np
import pytest

from oppositerenderer_tpu.camera import Camera as JCamera
from oppositerenderer_tpu_torch.camera import Camera

CAMERAS = [dict(eye=(0, 0, -5), lookat=(0, 0, 0), up=(0, 1, 0),
                hfov=60.0, vfov=60.0),
           dict(eye=(2.78, 2.73, -8.0), lookat=(2.78, 2.73, 0.0),
                up=(0, 1, 0), hfov=35.0, vfov=30.0, aperture=0.02),
           dict(eye=(1.0, 9.9, 0.5), lookat=(1.0, 0.0, 0.4), up=(0, 1, 0),
                hfov=45.0, vfov=45.0)]     # 0.6 degrees off the pole
OPS = [("scale_fov", (0.5,)), ("scale_fov", (1.7,)), ("scale_fov", (40.0,)),
       ("orbit", (0.5, 0.2)), ("orbit", (-2.0, 1.4)), ("orbit", (0.1, -3.0)),
       ("translate", (1.0, -0.5)), ("dolly", (0.3,))]
FIELDS = ("eye", "lookdir", "up", "camera_u", "camera_v", "aperture")


def make_cam(aperture=0.0):
    return Camera.make(eye=(0, 0, -5), lookat=(0, 0, 0), up=(0, 1, 0),
                       hfov=60.0, vfov=60.0, aperture=aperture, device="cpu")


def test_interactive_ops():
    cam = make_cam()
    cam2 = cam.dolly(0.5)
    assert float(np.linalg.norm(cam2.lookdir.numpy())) == pytest.approx(2.5)
    cam3 = cam.translate(1.0, 0.0)
    np.testing.assert_allclose((cam3.lookat - cam.lookat).numpy(),
                               cam.camera_u.numpy(), atol=1e-5)
    cam4 = cam.scale_fov(0.5)
    assert cam4.hfov < cam.hfov


@pytest.mark.parametrize("i", range(len(CAMERAS)))
@pytest.mark.parametrize("op,args", OPS)
def test_ops_match_jax(i, op, args):
    got = getattr(Camera.make(**CAMERAS[i], device="cpu"), op)(*args)
    want = getattr(JCamera.make(**CAMERAS[i]), op)(*args)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert (got.hfov, got.vfov) == pytest.approx((want.hfov, want.vfov),
                                                 rel=1e-12)
    assert got.eye.device.type == "cpu"


def test_orbit_keeps_the_distance_and_clamps_the_pole():
    cam = Camera.make(**CAMERAS[0], device="cpu")
    d0 = float(np.linalg.norm(cam.lookdir.numpy()))
    up = cam.orbit(0.3, 10.0)     # far past the pole: clamped at 1.55 rad
    rel = (up.eye - up.lookat).numpy().astype(np.float64)
    assert float(np.linalg.norm(rel)) == pytest.approx(d0, rel=1e-6)
    assert np.arcsin(rel[1] / np.linalg.norm(rel)) == pytest.approx(
        1.55, abs=1e-5)
    np.testing.assert_allclose(up.lookat.numpy(), cam.lookat.numpy(),
                               atol=1e-6)
