"""The port's CUDA kernels on the card, against their plain versions.

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest skips tests/conftest.py, which pins JAX to the CPU). Each
test skips where torch.cuda.is_available() is false. The stream fixture
`make_stream` is shared with tests/test_torch_blend.py, the dense one
`make_dense` with tests/test_torch_dense.py.
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.oracle import rasterize_oracle
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_bwd,
    blend_stream_bwd_compact,
    blend_stream_bwd_compact_plain,
    blend_stream_bwd_plain,
    blend_stream_fwd,
    blend_stream_fwd_plain,
    blend_tiles_bwd,
    blend_tiles_bwd_plain,
    blend_tiles_fwd,
    blend_tiles_fwd_plain,
    compact_offsets,
    segment_reduce,
    segment_reduce_plain,
)

GRID_X, GRID_Y = 4, 3
CHUNK = 32
K = 160  # max_per_tile of the dense fixtures: a multiple of CHUNK
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


def make_bwd_stream(seed=0, C=4):
    """make_stream's stream, with opacity 1 on five slots of tile 7 (their
    alpha clamps at 0.99 near their centers), its forward outputs from the
    plain version, and seeded cotangents g_accum [T, C, 256], g_t [T, 256]
    ~ N(0, 0.1^2). (A mean loss's cotangents are smaller still. At unit
    cotangents the conic gradients grow so large that near-cancelling sums
    over a tile's pixels differ by more than 3e-5 between two summation
    orders.)
    -> (rows, counts, tstart, toff, accum, t_final, g_accum, g_t)."""
    rows, counts, tstart, toff = make_stream(seed, C)
    rows[tstart[7]:tstart[7] + 5, 5] = 1.0
    acc, t_final = blend_stream_fwd_plain(
        *map(torch.as_tensor, (rows, counts, tstart, toff)), GRID_X, CHUNK)
    rng = np.random.default_rng(seed + 100)
    g_acc = rng.normal(0, 0.1, size=acc.shape).astype(np.float32)
    g_t = rng.normal(0, 0.1, size=t_final.shape).astype(np.float32)
    return rows, counts, tstart, toff, acc.numpy(), t_final.numpy(), g_acc, g_t


def make_dense(seed=0, C=4, tile_offset=0):
    """make_stream's tile runs laid out densely: row d of the block is the
    run of the stream tile whose pixels are those of image tile
    d + tile_offset. Every dead row (k >= counts) holds an opaque splat at
    the tile's center, which changes the blend wherever it is read.
    -> (gdata [T, K, 6+C], counts [T], and the stream: rows, counts,
    tstart, toff)."""
    rows, counts, tstart, toff = make_stream(seed, C)
    keep = np.flatnonzero(toff >= tile_offset)
    T = len(keep)
    gdata = np.zeros((T, K, rows.shape[1]), np.float32)
    dcounts = np.zeros(T, np.int32)
    for t in keep:
        d = toff[t] - tile_offset
        ox, oy = (toff[t] % GRID_X) * 16, (toff[t] // GRID_X) * 16
        gdata[d, :] = [ox + 8, oy + 8, 0.01, 0.0, 0.01, 0.99] + [1.0] * C
        gdata[d, :counts[t]] = rows[tstart[t]:tstart[t] + counts[t]]
        dcounts[d] = counts[t]
    return gdata, dcounts, (rows, counts, tstart, toff)


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
@pytest.mark.parametrize("C", [4, 7])
def test_bwd_kernel_matches_plain(cuda, C):
    args = [torch.as_tensor(x, device=cuda) for x in make_bwd_stream(C=C)]
    before = blend_stream_bwd.launches
    d = blend_stream_bwd(*args, GRID_X, CHUNK)
    torch.cuda.synchronize()
    assert blend_stream_bwd.launches == before + 1
    torch.testing.assert_close(d, blend_stream_bwd_plain(*args, GRID_X, CHUNK), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7])
def test_compact_bwd_kernel_matches_plain(cuda, C):
    """K4 against its plain version (rows and ids), and K4 + K3 against
    K2 + K3 per splat. The buffers come from torch.empty, and NaN-filled
    blocks of their sizes wait in the caching allocator, so a row or an id
    the kernel failed to write would show."""
    stream = make_bwd_stream(C=C)
    args = [torch.as_tensor(x, device=cuda) for x in stream]
    n = 57
    gauss = torch.as_tensor(np.random.default_rng(0).integers(0, n, stream[0].shape[0]),
                            dtype=torch.int32, device=cuda)
    rows = compact_offsets(args[1], CHUNK)[1] * CHUNK
    poison = [torch.full((rows, C + 6), float("nan"), device=cuda),
              torch.full((rows,), float("nan"), device=cuda)]
    del poison
    before = blend_stream_bwd_compact.launches
    d, ids = blend_stream_bwd_compact(*args[:4], gauss, *args[4:], GRID_X, CHUNK, n)
    torch.cuda.synchronize()
    assert blend_stream_bwd_compact.launches == before + 1
    d_p, ids_p = blend_stream_bwd_compact_plain(*args[:4], gauss, *args[4:], GRID_X, CHUNK, n)
    torch.testing.assert_close(d, d_p, **TOL)
    assert torch.equal(ids, ids_p)
    per = segment_reduce(d, ids, n)
    per2 = segment_reduce(blend_stream_bwd(*args, GRID_X, CHUNK), gauss, n)
    torch.testing.assert_close(per, per2, atol=1e-5 * float(per2.abs().max()), rtol=1e-4)


@pytest.mark.gpu
def test_reduce_kernel_matches_plain(cuda):
    rng = np.random.default_rng(5)
    rows = torch.as_tensor(rng.normal(0, 1, (50_000, 10)).astype(np.float32), device=cuda)
    ids = torch.as_tensor(rng.integers(0, 3001, 50_000).astype(np.int32), device=cuda)
    before = segment_reduce.launches
    out = segment_reduce(rows, ids, 3000)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    torch.testing.assert_close(out, segment_reduce_plain(rows, ids, 3000),
                               atol=2e-5, rtol=1e-4)


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


@pytest.mark.gpu
@pytest.mark.parametrize("C,tile_offset", [(4, 0), (7, 4)])
def test_dense_kernels_match_plain(cuda, C, tile_offset):
    gdata, counts, _ = make_dense(C=C, tile_offset=tile_offset)
    gdata[:, :5, 5] = 1.0  # alpha clamps at 0.99 near these splats' centers
    g, c = torch.as_tensor(gdata, device=cuda), torch.as_tensor(counts, device=cuda)
    before = (blend_tiles_fwd.launches, blend_tiles_bwd.launches)
    acc, t_final = blend_tiles_fwd(g, c, GRID_X, CHUNK, tile_offset)
    torch.cuda.synchronize()
    acc_p, t_p = blend_tiles_fwd_plain(g, c, GRID_X, CHUNK, tile_offset)
    torch.testing.assert_close(acc, acc_p, **TOL)
    torch.testing.assert_close(t_final, t_p, **TOL)
    rng = np.random.default_rng(3)
    g_acc = torch.as_tensor(rng.normal(0, 0.1, acc.shape).astype(np.float32), device=cuda)
    g_t = torch.as_tensor(rng.normal(0, 0.1, t_final.shape).astype(np.float32), device=cuda)
    args = (g, c, acc_p, t_p, g_acc, g_t, GRID_X, CHUNK, tile_offset)
    d = blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    assert (blend_tiles_fwd.launches, blend_tiles_bwd.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    torch.testing.assert_close(d, blend_tiles_bwd_plain(*args), **TOL)
    dead = torch.arange(K, device=cuda)[None, :] >= c[:, None]
    assert not d[dead].any()


@pytest.mark.gpu
def test_dense_rasterize_on_card_matches_stream(cuda):
    """The two input layouts on the card: equal images, gradients equal up
    to K3's atomic order, and each through its own kernels."""
    rng = np.random.default_rng(4)
    n = 300
    arrs = [np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.6, n),
                      rng.permutation(np.linspace(2.0, 6.0, n))], -1),
            np.exp(rng.normal(-2.5, 0.4, (n, 3))), rng.normal(size=(n, 4)),
            rng.uniform(0.1, 0.95, n), rng.uniform(size=(n, 5))]
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 90)
    outs = {}
    for layout in ("stream", "dense"):
        means, scales, quats, op, cols = (torch.tensor(a, dtype=torch.float32, device=cuda,
                                                       requires_grad=True) for a in arrs)
        before = blend_tiles_bwd.launches
        r = rasterize(cam, means, build_cov3d(scales, quats), op, cols,
                      torch.zeros(5, device=cuda),
                      RasterizeConfig(max_per_tile=256, chunk=32, pallas_input=layout))
        loss = (r.image ** 2).sum() + r.alpha.sum()
        grads = torch.autograd.grad(loss, (means, scales, op, cols))
        assert blend_tiles_bwd.launches == before + (layout == "dense")
        outs[layout] = r, grads
    (rs, gs), (rd, gd) = outs["stream"], outs["dense"]
    assert torch.equal(rs.image, rd.image) and torch.equal(rs.alpha, rd.alpha)
    for a, b in zip(gs, gd):
        torch.testing.assert_close(b, a, atol=1e-5 * float(a.abs().max()), rtol=1e-4)
