"""The port's dense input layout (RasterizeConfig(pallas_input="dense")):
the [T, K] splat-index matrix, the dense-block blend K5 and its backward
K6, against the JAX package.

The same numpy inputs go through the JAX package's dense binning, its Pallas
kernels `blend_tiles_pallas_fwd` / `blend_tiles_pallas_bwd` (interpret mode
on the CPU, as tests/test_pallas.py runs them) and its rasterizer with
`RasterizeConfig(backend="pallas", pallas_input="dense")`, and through the
port, whose wrappers run their plain versions on a CPU tensor. The CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py and tests/test_torch_gpu.py.

Traps to rule out before filing a mismatch as a fault:
  * Dead slots: row k >= counts[t] of a dense block holds splat 0's row (the
    index matrix is 0 there). Both packages must mask by counts; the
    fixtures put an opaque splat in every dead row, so reading one shows.
  * Depth ties, as in tests/test_torch_binning.py: well-separated depths.
  * Summation order: the per-slot gradients sum a tile's 256 pixels in
    another order in each package, hence the normalised gradient bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import binning as jbin
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu.ops.rasterize_pallas import (
    blend_tiles_pallas_bwd,
    blend_tiles_pallas_fwd,
)
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops import binning as tbin
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    _prepare,
    gather_rows,
    rasterize,
)
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_bwd_plain,
    blend_stream_fwd_plain,
    blend_tiles_bwd,
    blend_tiles_bwd_plain,
    blend_tiles_fwd,
    blend_tiles_fwd_plain,
)
from tests.test_rasterize import make_cam, random_scene
from tests.test_torch_binning import GX, GY, H, W, separated_scene
from tests.test_torch_gpu import CHUNK, GRID_X, K, dense_starts, make_dense
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)


def cotangents(acc, t_final, seed=100):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, size=acc.shape).astype(np.float32),
            rng.normal(0, 0.1, size=t_final.shape).astype(np.float32))


@pytest.mark.parametrize("tile_offset", [0, 4])
def test_plain_dense_blend_matches_pallas(tile_offset):
    gdata, counts, _ = make_dense(C=4, tile_offset=tile_offset)
    acc_j, t_j = blend_tiles_pallas_fwd(jnp.asarray(gdata), jnp.asarray(counts), GRID_X,
                                        CHUNK, jnp.asarray([tile_offset], jnp.int32))
    acc, t_final = blend_tiles_fwd(torch.as_tensor(gdata), torch.as_tensor(counts),
                                   GRID_X, CHUNK, tile_offset)
    assert acc.shape == (len(counts), 4, 256)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), **TOL)
    np.testing.assert_allclose(t_final.numpy(), np.asarray(t_j), **TOL)
    assert (t_final.numpy()[counts == 0] == 1.0).all()  # dead rows never read


@pytest.mark.parametrize("tile_offset", [0, 4])
def test_plain_dense_bwd_matches_pallas(tile_offset):
    """K6's rows, at the stream positions of the block's slots, against the
    JAX kernel's d_slot [T, K, F] at the live slots; every other row of the
    stream zero, as the JAX kernel's dead slots are."""
    gdata, counts, stream = make_dense(C=7, tile_offset=tile_offset)
    gdata[:, :5, 5] = 1.0  # alpha clamps at 0.99 near these splats' centers
    g, c = torch.as_tensor(gdata), torch.as_tensor(counts)
    acc, t_final = blend_tiles_fwd_plain(g, c, GRID_X, CHUNK, tile_offset)
    g_acc, g_t = cotangents(acc.numpy(), t_final.numpy())
    want = np.asarray(blend_tiles_pallas_bwd(
        jnp.asarray(gdata), jnp.asarray(counts), jnp.asarray(acc.numpy()),
        jnp.asarray(t_final.numpy()), jnp.asarray(g_acc), jnp.asarray(g_t), GRID_X,
        CHUNK, jnp.asarray([tile_offset], jnp.int32)))
    tstart = dense_starts(stream, tile_offset)
    P = stream[0].shape[0]
    got = blend_tiles_bwd(g, c, torch.as_tensor(tstart), P, acc, t_final,
                          torch.as_tensor(g_acc), torch.as_tensor(g_t), GRID_X, CHUNK,
                          tile_offset).numpy()
    assert got.shape == (P, gdata.shape[2])
    live = np.arange(K)[None, :] < counts[:, None]
    pos = tstart[:, None] + np.arange(K)[None, :]
    # sums over a tile's pixels in another order: within 1e-5 of the largest
    assert_normalised(got[pos[live]], want[live], 1e-5, "d_slot")
    assert not want[~live].any()  # the JAX kernel's zeros past counts
    others = np.ones(P, bool)
    others[pos[live]] = False
    assert not got[others].any()  # the rows of tiles left out of the block
    assert others.any() == (tile_offset > 0)
    assert np.abs(got).max() > 1.0


def test_dense_plain_equals_stream_plain():
    """A dense block is a stream whose tile t starts at t * K: K5's plain
    version equals K1's on that strided stream, and, as both layouts must,
    K1's on the compact stream the block was laid out from, bit for bit;
    likewise K6 and K2, whose rows K6 writes at the same stream positions."""
    gdata, counts, (rows, s_counts, tstart, toff) = make_dense(seed=3, C=7)
    T = len(counts)
    g, c = torch.as_tensor(gdata), torch.as_tensor(counts)
    acc, t_final = blend_tiles_fwd_plain(g, c, GRID_X, CHUNK)
    ar = torch.arange(T, dtype=torch.int32)
    strided = (g.view(T * K, -1), c, ar * K, ar)
    acc_s, t_s = blend_stream_fwd_plain(*strided, GRID_X, CHUNK)
    assert torch.equal(acc, acc_s) and torch.equal(t_final, t_s)
    stream = tuple(map(torch.as_tensor, (rows, s_counts, tstart, toff)))
    acc_c, t_c = blend_stream_fwd_plain(*stream, GRID_X, CHUNK)
    perm = torch.as_tensor(toff).long()  # stream tile t is dense row toff[t]
    assert torch.equal(acc[perm], acc_c) and torch.equal(t_final[perm], t_c)

    g_acc, g_t = map(torch.as_tensor, cotangents(acc.numpy(), t_final.numpy(), seed=7))
    d_rows = blend_tiles_bwd_plain(g, c, torch.as_tensor(dense_starts((rows, s_counts,
                                                                      tstart, toff))),
                                   rows.shape[0], acc, t_final, g_acc, g_t, GRID_X, CHUNK)
    d_s = blend_stream_bwd_plain(*strided, acc, t_final, g_acc, g_t, GRID_X, CHUNK)
    d_c = blend_stream_bwd_plain(*stream, acc_c, t_c, g_acc[perm], g_t[perm], GRID_X,
                                 CHUNK)
    assert torch.equal(d_rows, d_c)
    for t in range(T):
        n, d = int(s_counts[t]), int(toff[t])
        assert torch.equal(d_s[d * K:d * K + n], d_c[tstart[t]:tstart[t] + n])
    assert d_c.abs().max() > 0


def test_dense_wrappers_validate_inputs():
    gdata, counts, _ = make_dense()
    g, c = torch.as_tensor(gdata), torch.as_tensor(counts)
    with pytest.raises(ValueError, match="multiple of chunk"):
        blend_tiles_fwd(g, c, GRID_X, 48)
    with pytest.raises(ValueError, match="gdata must be float32"):
        blend_tiles_fwd(g.double(), c, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="counts must be int32"):
        blend_tiles_fwd(g, c[:-1], GRID_X, CHUNK)
    acc, t_final = blend_tiles_fwd(g, c, GRID_X, CHUNK)
    starts = torch.zeros_like(c)
    with pytest.raises(ValueError, match="g_t must be float32"):
        blend_tiles_bwd(g, c, starts, 10, acc, t_final, acc, t_final[:, :8], GRID_X, CHUNK)
    with pytest.raises(ValueError, match="tstart must be int32"):
        blend_tiles_bwd(g, c, starts.long(), 10, acc, t_final, acc, t_final, GRID_X, CHUNK)


def test_entry_types_match_the_c_signatures():
    """Each C entry's ctypes argument types match its signature in csrc/,
    parameter for parameter, with the stream last: a missing type makes
    ctypes pass a 64-bit argument as a 32-bit int."""
    import ctypes
    import re

    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    for name, (stem, argtypes) in rk._ENTRIES.items():
        src = (rk.CSRC / f"{stem}.cu").read_text()
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_longlong if "long long" in p else ctypes.c_int for p in params]
        assert argtypes == want, name
        assert "void* stream" in params[-1], name


def test_config_requires_a_chunk_multiple():
    with pytest.raises(ValueError, match="max_per_tile must be a multiple of chunk"):
        RasterizeConfig(max_per_tile=100, chunk=64)
    with pytest.raises(ValueError, match="pallas_input"):
        RasterizeConfig(pallas_input="compact")


@pytest.mark.parametrize("max_per_tile", [1024, 64])
def test_dense_index_matches_jax(max_per_tile):
    """gauss_idx and counts against JAX bin_gaussians(dense=True): live
    slots front to back, dead slots 0, counts clamped at K (the 64 case
    truncates deep tiles)."""
    means, scales, quats, op = separated_scene(400, 1)
    cov = np.array(jproj.build_cov3d(scales, quats))
    pj = jproj.project(means, cov, make_cam(W, H), opacities=op)
    a = jbin.bin_gaussians(pj, GX, GY, 16384, max_per_tile, dense=True, stream=False)
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    pt = tproj.project(*map(torch.as_tensor, (means, cov)), cam,
                       opacities=torch.as_tensor(op))
    b = tbin.bin_gaussians(pt, GX, GY, max_per_tile, dense=True)
    np.testing.assert_array_equal(b.counts.numpy(), np.asarray(a.counts))
    np.testing.assert_array_equal(b.gauss_idx.numpy(), np.asarray(a.gauss_idx))
    assert b.gauss_idx.dtype == torch.int32
    assert int(b.n_truncated) == int(a.n_truncated)
    assert (int(b.n_truncated) > 0) == (max_per_tile == 64)
    assert tbin.bin_gaussians(pt, GX, GY, max_per_tile).gauss_idx is None


def test_dense_block_is_the_gathered_runs():
    """The dense layout's block holds, in row t, the stream layout's rows of
    tile t; the port's render path builds it with gather_rows."""
    means, scales, quats, op = separated_scene(300, 2)
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    cov = tproj.build_cov3d(*map(torch.as_tensor, (scales, quats)))
    cfg = RasterizeConfig(max_per_tile=256, chunk=32, pallas_input="dense")
    proj, bins, _ = _prepare(cam, torch.as_tensor(means), cov, torch.as_tensor(op), cfg)
    pay = torch.rand(300, 3, generator=torch.Generator().manual_seed(0))
    args = (proj.mean2d, proj.conic, torch.as_tensor(op), pay)
    gdata = gather_rows(*args, bins.gauss_idx)
    rows = gather_rows(*args, bins.sorted_gauss)
    assert gdata.shape == (GX * GY, 256, 9)
    for t, (s, n) in enumerate(zip(bins.tile_start.tolist(), bins.counts.tolist())):
        assert torch.equal(gdata[t, :n], rows[s:s + n])


def test_dense_rasterize_matches_jax():
    """Images and gradients of rasterize(pallas_input="dense") against the
    JAX package's dense Pallas path, on tests/test_pallas.py:43-70's scene
    and loss; and the port's two layouts against each other."""
    means, scales, quats, op, cols = random_scene(120, seed=3)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    target = np.random.default_rng(4).uniform(size=(32, 48, 3)).astype(np.float32)
    cam = make_cam(48, 32)
    jcfg = JConfig(max_per_tile=128, chunk=32, min_intersections=16384, backend="pallas",
                   pallas_input="dense")

    def jloss(means, scales, quats, op, cols):
        out = jrasterize(cam, means, jproj.build_cov3d(scales, quats), op, cols,
                         jnp.asarray(bg), jcfg)
        return (jnp.sum((out.image - target) ** 2) + 0.05 * jnp.sum(out.alpha)
                + 0.01 * jnp.sum(out.depth)), out

    args = (means, scales, quats, op, cols)
    (j_loss, j_out), want = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                               has_aux=True)(*args)
    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 48, 32)
    results = {}
    for layout in ("dense", "stream"):
        targs = [torch.tensor(np.array(a), requires_grad=True) for a in args]
        m, s, q, o, c = targs
        out = rasterize(tc, m, tproj.build_cov3d(s, q), o, c, torch.as_tensor(bg),
                        RasterizeConfig(max_per_tile=128, chunk=32, pallas_input=layout))
        assert int(out.n_truncated) == 0
        loss = ((out.image - torch.as_tensor(target)) ** 2).sum() \
            + 0.05 * out.alpha.sum() + 0.01 * out.depth.sum()
        results[layout] = (out, loss, torch.autograd.grad(loss, targs))
    out, loss, got = results["dense"]
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(out, k).detach().numpy(),
                                   np.asarray(getattr(j_out, k)), **TOL, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    for name, g, w in zip(("means", "scales", "quats", "op", "cols"), got, want):
        assert_normalised(g.numpy(), w, 1e-3, name)
        assert float(np.abs(np.asarray(w)).max()) > 0, name
    # the stream and dense layouts walk the same rows: equal images, and
    # gradients equal up to the order in which K3 sums a splat's slots
    s_out, s_loss, s_got = results["stream"]
    assert torch.equal(out.image, s_out.image) and torch.equal(out.alpha, s_out.alpha)
    for g, h in zip(got, s_got):
        assert_normalised(g.numpy(), h.numpy(), 1e-6, "layouts")
