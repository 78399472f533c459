"""The port's CUDA kernels on the card, against their plain versions.

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest skips tests/conftest.py, which pins JAX to the CPU). Each
test skips where torch.cuda.is_available() is false. The stream fixture
`make_stream` is shared with tests/test_torch_blend.py.
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.oracle import rasterize_oracle
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_fwd,
    blend_stream_fwd_plain,
)

GRID_X, GRID_Y = 4, 3
CHUNK = 32
TOL = dict(atol=3e-5, rtol=1e-4)


def make_stream(seed=0, C=4):
    """A slot stream [P, 6 + C] whose per-tile runs cover: heavy overdraw
    (every pixel stops early), counts that are not multiples of CHUNK,
    empty tiles, and slots whose power is > 0 or whose alpha is < 1/255 at
    some pixels. Pixel coordinates come through a permuted toff table."""
    rng = np.random.default_rng(seed)
    T = GRID_X * GRID_Y
    counts = np.array([150, 45, 0, 7, 64, 33, 0, 96, 1, 31, 12, 0], np.int32)
    toff = rng.permutation(T).astype(np.int32)
    rows = []
    for t in range(T):
        k = counts[t]
        ox, oy = (toff[t] % GRID_X) * 16, (toff[t] // GRID_X) * 16
        mean = np.stack([ox + rng.uniform(-4, 20, k), oy + rng.uniform(-4, 20, k)], -1)
        a = rng.uniform(0.005, 0.08, k)
        c = rng.uniform(0.005, 0.08, k)
        b = rng.uniform(-0.5, 0.5, k) * np.sqrt(a * c)
        opac = rng.uniform(0.05, 0.99, k)
        if t == 0:  # heavy overdraw: wide opaque splats, every pixel stops
            a, c, b = a * 0.1, c * 0.1, b * 0.1
            opac = rng.uniform(0.6, 0.99, k)
        if t == 3:  # indefinite conics (power > 0 somewhere), faint splats
            b = np.full(k, 0.2)
            opac[:3] = 0.003
        pay = rng.uniform(0, 1, (k, C))
        rows.append(np.concatenate(
            [mean, a[:, None], b[:, None], c[:, None], opac[:, None], pay], -1))
    rows = np.concatenate(rows).astype(np.float32)
    tstart = (np.cumsum(counts) - counts).astype(np.int32)
    return rows, counts, tstart, toff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7, 16])
def test_kernel_matches_plain(cuda, C):
    args = [torch.as_tensor(x, device=cuda) for x in make_stream(C=C)]
    before = blend_stream_fwd.launches
    acc, t_final = blend_stream_fwd(*args, GRID_X, CHUNK)
    torch.cuda.synchronize()
    assert blend_stream_fwd.launches == before + 1
    acc_p, t_p = blend_stream_fwd_plain(*args, GRID_X, CHUNK)
    torch.testing.assert_close(acc, acc_p, **TOL)
    torch.testing.assert_close(t_final, t_p, **TOL)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda):
    rows, counts, tstart, toff = (torch.as_tensor(x, device=cuda)
                                  for x in make_stream(C=17))
    with pytest.raises(ValueError, match="at most 16 channels"):
        blend_stream_fwd(rows, counts, tstart, toff, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="counts is on"):
        blend_stream_fwd(rows, counts.cpu(), tstart, toff, GRID_X, CHUNK)


@pytest.mark.gpu
def test_rasterize_on_card_matches_oracle(cuda):
    rng = np.random.default_rng(3)
    n = 300
    arrs = [np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.6, n),
                      rng.permutation(np.linspace(2.0, 6.0, n))], -1),
            np.exp(rng.normal(-2.5, 0.4, (n, 3))), rng.normal(size=(n, 4)),
            rng.uniform(0.1, 0.95, n), rng.uniform(size=(n, 5))]
    means, scales, quats, op, cols = (torch.as_tensor(a, dtype=torch.float32)
                                      for a in arrs)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 90)
    cov = build_cov3d(scales, quats)
    bg = torch.linspace(0, 1, 5)
    cfg = RasterizeConfig(tight_radius=False)
    before = blend_stream_fwd.launches
    r = rasterize(cam, *(x.to(cuda) for x in (means, cov, op, cols, bg)), cfg)
    assert blend_stream_fwd.launches == before + 1  # no CPU fallback
    o = rasterize_oracle(cam, means, cov, op, cols, bg)
    torch.testing.assert_close(r.image.cpu(), o["image"], **TOL)
    torch.testing.assert_close(r.alpha.cpu(), o["alpha"], **TOL)
    torch.testing.assert_close(r.depth.cpu(), o["depth"], atol=3e-4, rtol=1e-4)
    assert torch.equal(r.radii.cpu(), o["radii"])
