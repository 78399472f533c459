"""The port's render slice against the JAX package and the naive oracle.

One random GaussianState (numpy, seeded, padded to a 4096 capacity) goes
into both packages through `state_from_numpy`. The JAX package renders with
its Pallas stream kernel (interpret mode on the CPU); the port with its
plain blend on the CPU.

Traps to rule out before filing a mismatch as a fault:
  * Depth ties: the blend order within a tile is a stable argsort of float32
    depth; the fixture's depths are well separated.
  * Padded splats: capacity padding (alive=False, logit_opacity=-10) must
    cull the same way in both packages: opacity 0, radius 0, no slots.
  * Ragged last tile row: 80 and 968 are multiples of 16, 90 is not; the
    fixture's 96x90 frame makes `_untile` crop a partial tile row, as the
    1296x968 frame of chip_smoke.py does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models.gaussians import GaussianState as JState
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.render import render as jrender
from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import state_from_numpy
from opengaussian_tpu_torch.ops.oracle import rasterize_oracle
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from opengaussian_tpu_torch.render import render

torch.set_num_threads(1)

W, H = 96, 90
JCFG = JConfig(backend="pallas", max_per_tile=128, chunk=32, min_intersections=16384)
TCFG = RasterizeConfig(max_per_tile=128, chunk=32)
TOL = dict(atol=3e-5, rtol=1e-4)


def random_state_arrays(n=300, cap=4096, seed=0, spread=0.6):
    """GaussianState fields as numpy, n alive splats padded to `cap` the way
    the JAX package pads (identity quats, logit_opacity -10, alive False)."""
    rng = np.random.default_rng(seed)
    z = rng.permutation(np.linspace(2.0, 6.0, n))  # well-separated depths
    means = np.stack([rng.normal(0, spread, n), rng.normal(0, spread, n), z], -1)
    d = dict(
        means=means,
        sh_dc=rng.normal(0, 0.8, (n, 1, 3)),
        sh_rest=rng.normal(0, 0.2, (n, 15, 3)),
        log_scales=rng.normal(-2.6, 0.4, (n, 3)),
        quats=rng.normal(size=(n, 4)),
        logit_opacity=rng.normal(0.0, 2.0, n),
        ins_feat=rng.normal(size=(n, 6)),
    )
    out = {}
    for k, v in d.items():
        pad = np.zeros((cap,) + v.shape[1:], np.float32)
        pad[:n] = v
        out[k] = pad
    out["quats"][n:, 0] = 1.0
    out["logit_opacity"][n:] = -10.0
    out["alive"] = np.arange(cap) < n
    return out


def cameras(w=W, h=H, angle=0.15):
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    t = np.array([0.1, -0.05, 0.3])
    return (JCamera.from_fov(R, t, 0.9, 0.8, w, h),
            Camera.from_fov(R, t, 0.9, 0.8, w, h))


@pytest.mark.parametrize("rescale", [1.0, 0.7])
def test_render_matches_jax(rescale):
    arrays = random_state_arrays()
    jstate = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tstate = state_from_numpy(arrays, device="cpu")
    jcam, tcam = cameras()
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    a = jrender(jcam, jstate, jnp.asarray(bg), 3, JCFG, render_color=True,
                render_feat_map=True, rescale_factor=rescale, scale_modifier=1.1)
    b = render(tcam, tstate, torch.as_tensor(bg), 3, TCFG, render_color=True,
               render_feat_map=True, rescale_factor=rescale, scale_modifier=1.1)
    for f in ("render", "alpha", "depth", "ins_feat", "silhouette"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
        assert y.shape == x.shape, f
        np.testing.assert_allclose(y, x, err_msg=f, **TOL)
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    np.testing.assert_array_equal(b.visibility_filter.numpy(),
                                  np.asarray(a.visibility_filter))
    assert int(b.n_lost) == int(a.n_lost)
    assert (b.radii.numpy()[300:] == 0).all()  # padded splats are culled
    assert float(b.alpha.max()) > 0.9  # the frame is not empty


def test_render_feature_only_pass():
    tstate = state_from_numpy(random_state_arrays(seed=1), device="cpu")
    _, tcam = cameras(64, 48)
    out = render(tcam, tstate, torch.zeros(3), 3, TCFG, render_color=False,
                 render_feat_map=True)
    assert out.render is None and out.ins_feat.shape == (48, 64, 6)
    assert out.radii is not None and int(out.visibility_filter.sum()) > 0


@pytest.mark.parametrize("tight", [False, True])
def test_rasterize_matches_oracle(tight):
    arrays = random_state_arrays(n=200, cap=200, seed=2)
    s = state_from_numpy(arrays, device="cpu")
    _, cam = cameras(64, 48)
    cov = build_cov3d(s.scales, s.quats)
    cols = torch.as_tensor(np.random.default_rng(3).uniform(size=(200, 3)),
                           dtype=torch.float32)
    bg = torch.tensor([0.2, 0.1, 0.4])
    cfg = dataclasses.replace(TCFG, max_per_tile=1024, tight_radius=tight)
    r = rasterize(cam, s.means, cov, s.opacity, cols, bg, cfg)
    o = rasterize_oracle(cam, s.means, cov, s.opacity, cols, bg)
    torch.testing.assert_close(r.image, o["image"], **TOL)
    torch.testing.assert_close(r.alpha, o["alpha"], **TOL)
    torch.testing.assert_close(r.depth, o["depth"], atol=3e-4, rtol=1e-4)
    if not tight:  # the oracle uses the classic 3-sigma radius
        assert torch.equal(r.radii, o["radii"])
    assert int(r.n_truncated) == 0


def test_rasterize_is_forward_only():
    """The forward is the same with and without autograd; with it, the
    backward (StreamBlend) gives finite gradients. Their values are held
    against jax.grad in tests/test_torch_rasterize_grad.py."""
    s = state_from_numpy(random_state_arrays(n=20, cap=20), device="cpu")
    _, cam = cameras(32, 32)
    means = s.means.clone().requires_grad_(True)
    out = rasterize(cam, means, build_cov3d(s.scales, s.quats), s.opacity,
                    s.means, torch.zeros(3))
    out.image.sum().backward()
    assert means.grad is not None and bool(torch.isfinite(means.grad).all())
    assert float(means.grad.abs().sum()) > 0
    with torch.no_grad():
        out2 = rasterize(cam, means, build_cov3d(s.scales, s.quats), s.opacity,
                         s.means, torch.zeros(3))
    assert out2.image.shape == (32, 32, 3)
    assert torch.equal(out2.image, out.image.detach())
