"""Port stream binning against the JAX package's `bin_gaussians`.

Traps to rule out before filing a mismatch as a fault:
  * Depth ties: the minor sort key is a stable argsort of float32 depth
    (opengaussian_tpu/ops/binning.py:60-69). One ulp of difference in a
    depth can swap two splats within a tile, so the fixtures use
    well-separated depths.
  * Sort key width: the JAX package fuses (tile, depth rank) into one int32;
    the port sorts an int64 key. Both orders are the same for live slots,
    whose (tile, rank) pairs are unique.
  * Stream length: the JAX stream has the fixed budget P, the port's the
    frame's exact total, so only each tile's run is compared.
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import binning as jbin
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops import binning as tbin
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops.rasterize import gather_rows
from tests.test_rasterize import make_cam, random_scene

torch.set_num_threads(1)

W, H = 96, 80
GX, GY = (W + 15) // 16, (H + 15) // 16


def separated_scene(n, seed):
    means, scales, quats, op, _ = random_scene(n, seed=seed)
    means = np.array(means)
    # distinct depths at least 4/n apart: no ties, no near-ties
    means[:, 2] = np.random.default_rng(seed).permutation(np.linspace(2.0, 6.0, n))
    return means.astype(np.float32), np.array(scales), np.array(quats), np.array(op)


def both_bins(n, seed, max_per_tile, tight=True):
    means, scales, quats, op = separated_scene(n, seed)
    cov = np.array(jproj.build_cov3d(scales, quats))
    pj = jproj.project(means, cov, make_cam(W, H), opacities=op if tight else None)
    a = jbin.bin_gaussians(pj, GX, GY, 16384, max_per_tile, dense=False, stream=True)
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    pt = tproj.project(*map(torch.as_tensor, (means, cov)), cam,
                       opacities=torch.as_tensor(op) if tight else None)
    b = tbin.bin_gaussians(pt, GX, GY, max_per_tile)
    return a, b


@pytest.mark.parametrize("tight", [False, True])
def test_stream_matches_jax(tight):
    a, b = both_bins(300, seed=0, max_per_tile=1024, tight=tight)
    counts = np.asarray(a.counts)
    np.testing.assert_array_equal(b.counts.numpy(), counts)
    np.testing.assert_array_equal(b.tile_start.numpy(), np.asarray(a.tile_start))
    live = int(counts.sum())
    np.testing.assert_array_equal(b.sorted_gauss.numpy()[:live],
                                  np.asarray(a.sorted_gauss)[:live])
    assert int(a.n_dropped) == int(b.n_dropped) == 0
    assert int(a.n_truncated) == int(b.n_truncated) == 0
    assert int(b.total) == int(a.total)
    assert int(b.deepest) == counts.max()
    if tight:  # the circle cull removed corner slots the rect counted
        assert live < int(b.total)


def test_truncated_runs_match_jax():
    """The max_per_tile cap keeps the same front slots of every run."""
    a, b = both_bins(400, seed=1, max_per_tile=64)
    counts, tstart = np.asarray(a.counts), np.asarray(a.tile_start)
    np.testing.assert_array_equal(b.counts.numpy(), counts)
    np.testing.assert_array_equal(b.tile_start.numpy(), tstart)
    assert int(a.n_truncated) == int(b.n_truncated) > 0
    assert int(b.deepest) > 64
    sa, sb = np.asarray(a.sorted_gauss), b.sorted_gauss.numpy()
    for s, c in zip(tstart, counts):
        np.testing.assert_array_equal(sb[s:s + c], sa[s:s + c])


def test_carry_rides_the_sort():
    """The blend's rows reach the stream through one gather by sorted_gauss
    (rasterize.gather_rows): every slot carries its own splat's row."""
    carry = torch.arange(100, dtype=torch.float32)[:, None] * torch.ones(1, 3)
    means, scales, quats, op = separated_scene(100, 2)
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    pt = tproj.project(torch.as_tensor(means),
                       tproj.build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats)),
                       cam, opacities=torch.as_tensor(op))
    bc = tbin.bin_gaussians(pt, GX, GY, 1024)
    rows = gather_rows(pt.mean2d, pt.conic, torch.as_tensor(op), carry, bc.sorted_gauss)
    assert rows.shape == (bc.sorted_gauss.shape[0], 6 + 3)
    assert torch.equal(rows[:, 6].long(), bc.sorted_gauss.long())
    assert torch.equal(rows[:, :2], pt.mean2d[bc.sorted_gauss.long()])
    # within a tile, slots run front to back
    d = pt.depth[bc.sorted_gauss.long()]
    for s, c in zip(bc.tile_start.tolist(), bc.counts.tolist()):
        assert bool((d[s + 1:s + c] > d[s:s + c - 1]).all())
