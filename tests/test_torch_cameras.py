"""Port cameras and device selection against the JAX package."""

import numpy as np
import pytest
import torch

from opengaussian_tpu import cameras as jcam
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.device import resolve_device

torch.set_num_threads(1)


def _rot(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("kind", ["fov", "K"])
def test_camera_matches_jax(kind):
    R, t = _rot(0), np.array([0.3, -0.2, 4.0])
    if kind == "fov":
        a = jcam.Camera.from_fov(R, t, 0.9, 0.7, 96, 80)
        b = tcam.Camera.from_fov(R, t, 0.9, 0.7, 96, 80)
    else:
        K = np.array([[70.0, 0, 47.0], [0, 65.0, 41.0], [0, 0, 1]])
        a = jcam.Camera.from_K(R, t, K, 96, 80)
        b = tcam.Camera.from_K(R, t, K, 96, 80)
    for f in ("R_w2c", "t_w2c", "fx", "fy", "cx", "cy"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert y.dtype == np.float32 and np.array_equal(x, y), f
    assert (a.width, a.height) == (b.width, b.height)
    # tanfov rounds in float32 in both packages
    assert np.asarray(a.tanfovx) == b.tanfovx.numpy()
    assert np.asarray(a.tanfovy) == b.tanfovy.numpy()
    np.testing.assert_allclose(b.cam_center.numpy(), np.asarray(a.cam_center),
                               rtol=1e-6, atol=1e-6)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(b.world_to_cam(torch.as_tensor(pts)).numpy(),
                               np.asarray(a.world_to_cam(pts)), rtol=1e-6, atol=1e-6)


def test_fov_focal_roundtrip():
    for fov, px in ((0.9, 96), (1.3, 1296)):
        assert tcam.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        assert tcam.focal2fov(tcam.fov2focal(fov, px), px) == pytest.approx(fov)


def test_camera_moves_between_devices():
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48)
    assert cam.to("cpu") is cam and cam.device.type == "cpu"


def test_cuda_default_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
