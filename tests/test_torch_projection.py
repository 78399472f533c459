"""Port projection and SH against the JAX package.

Trap to rule out before filing a radius mismatch as a fault: `radius` and
the tile rect are ceil/truncations of float32 values, so a one-ulp
difference in the camera-space point (a 3x3 matmul that sums in another
order) could move a splat exactly on an integer boundary. The fixtures here
hold none; the comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import sh as jsh
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops import sh as tsh
from tests.test_rasterize import make_cam, random_scene

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_cov3d_matches_jax():
    _, scales, quats, _, _ = random_scene(200, seed=3)
    a = np.asarray(jproj.build_cov3d(scales, quats))
    b = tproj.build_cov3d(_t(scales), _t(quats)).numpy()
    # values ~1e-2; off-diagonals cancel, so the sum order shows at ~1e-8
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("tight", [False, True])
def test_project_matches_jax(tight):
    means, scales, quats, op, _ = random_scene(300, seed=4, zmin=0.1, zmax=6.0)
    jc = make_cam(96, 80)
    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 80)
    cov = jproj.build_cov3d(scales, quats)
    a = jproj.project(means, cov, jc, opacities=op if tight else None)
    b = tproj.project(_t(means), _t(cov), tc, opacities=_t(op) if tight else None)
    for f in ("radius", "rect_min", "rect_max", "num_tiles", "valid"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        np.testing.assert_array_equal(y, x, err_msg=f)
    for f in ("mean2d", "depth", "conic", "cull_radius"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5, err_msg=f)
    assert (np.asarray(a.valid)).sum() > 100  # most splats are on screen
    assert not np.asarray(a.valid).all()  # and the near cull fires


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_to_rgb_matches_jax(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(0, 0.5, (100, 25, 3)).astype(np.float32)
    means = rng.normal(size=(100, 3)).astype(np.float32)
    center = np.array([0.1, -0.3, 2.0], np.float32)
    a = np.asarray(jsh.sh_to_rgb(deg, jnp.asarray(coeffs), jnp.asarray(means),
                                 jnp.asarray(center)))
    b = tsh.sh_to_rgb(deg, _t(coeffs), _t(means), _t(center)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_dc_to_rgb(tsh.rgb_to_sh(_t(rgb))).numpy(),
                               rgb, atol=1e-6)
