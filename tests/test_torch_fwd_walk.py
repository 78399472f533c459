"""A plain model of the redesigned forward walk (csrc/blend_tile.cuh:
blend_run_fwd, the walk of K1 and K5), held against the plain versions of
K1 and K5 and the JAX package's kernel.

The CUDA kernels run only on the card; what the redesign changes in the
walk is modelled here in plain PyTorch, one tile (CTA) at a time, with the
kernel's fp32 arithmetic: a warp whose 16x2 pixel rectangle misses a slot's
cull box (`slot_box_plain`) skips the slot, a pixel that stops leaves the
walk, and the tile stops at the first chunk boundary where all its pixels
have stopped. Asynchronous staging and the channel buckets change which
instructions run, not what they compute, so the model leaves them out. It
must give
  * `blend_stream_fwd_plain`'s accum and t_final bit for bit (and, over a
    dense block, `blend_tiles_fwd_plain`'s);
  * the JAX package's `blend_stream_pallas_fwd` (interpret mode) within the
    usual tolerance;
  * as its evaluations the "in_box" pairs of count_work, on which
    chip_smoke.py bases the forward kernels' bounds.
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.ops import blend
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    NPIX,
    WARP,
    _pixels,
    _strided,
    blend_stream_fwd_plain,
    blend_tiles_fwd_plain,
)
from tests.test_torch_blend import jax_blend
from tests.test_torch_gpu import (
    CHUNK,
    GRID_X,
    make_bwd_stream,
    make_deep_bwd_stream,
    make_dense,
    make_flat_bwd_stream,
)
from tests.test_torch_replay import culled, slot_box

torch.set_num_threads(1)

MAKES = [make_bwd_stream, make_deep_bwd_stream, make_flat_bwd_stream]


def fwd_walk_model(rows, counts, tstart, toff, grid_x: int,
                   chunk: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The culled forward walk in plain PyTorch, one tile at a time, over
    its 256 pixels: chunk by chunk until every pixel stopped, slot by slot
    in depth order, evaluating a slot only for the live pixels of the warps
    whose rectangle meets its box, and adding a composited slot's payload
    times its weight to each accumulator, as the kernel does.
    -> (accum [T, C, 256], t_final [T, 256], the (slot, pixel) pairs
    evaluated)."""
    rows = np.asarray(rows, np.float32)
    rows_t = torch.as_tensor(rows)
    C = rows.shape[1] - 6
    T = len(counts)
    accum = torch.zeros((T, C, NPIX), dtype=torch.float32)
    t_final = torch.ones((T, NPIX), dtype=torch.float32)
    boxes = slot_box(rows)
    px, py = (x[:, 0] for x in _pixels(torch.as_tensor(toff), grid_x, "cpu"))
    n_eval = 0
    for t in range(T):
        cnt, t0 = int(counts[t]), int(tstart[t])
        ox, oy = int(toff[t] % grid_x) * 16, int(toff[t] // grid_x) * 16
        trans = torch.ones(NPIX)
        done = torch.zeros(NPIX, dtype=torch.bool)
        acc = torch.zeros((C, NPIX))
        for base in range(0, cnt, chunk):
            if bool(done.all()):
                break
            for k in range(base, min(base + chunk, cnt)):
                g = rows_t[t0 + k]
                skip = torch.as_tensor(np.repeat(culled(boxes[t0 + k], ox, oy), WARP))
                live = ~skip & ~done
                n_eval += int(live.sum())
                dx, dy = g[0] - px[t], g[1] - py[t]
                power = -0.5 * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy
                gauss = torch.exp(torch.clamp(power, max=0.0))
                araw = torch.where(power <= 0.0, g[5] * gauss, 0.0)
                a = torch.clamp(araw, max=blend.ALPHA_MAX)
                a = torch.where((a >= blend.ALPHA_MIN) & live, a, 0.0)
                t_next = trans * (1.0 - a)
                stop = (a > 0.0) & (t_next < blend.T_EPS)
                contrib = (a > 0.0) & ~stop
                w = a * trans
                acc = torch.where(contrib, acc + g[6:, None] * w, acc)
                trans = torch.where(contrib, t_next, trans)
                done = done | stop
        accum[t], t_final[t] = acc, trans
    return accum, t_final, n_eval


@pytest.mark.parametrize("make", MAKES)
def test_culled_fwd_walk_equals_plain_bitwise(make):
    """The walk with the warp cull: blend_stream_fwd_plain's accum and
    t_final bit for bit, on runs of several chunks with a tile whose pixels
    all stop early, on a run of over ten chunks and on flat opaque splats."""
    stream = make()[:4]
    assert stream[1].max() > CHUNK
    acc, t_final, _ = fwd_walk_model(*stream, GRID_X, CHUNK)
    acc_p, t_p = blend_stream_fwd_plain(*map(torch.as_tensor, stream), GRID_X, CHUNK)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)
    assert acc_p.abs().max() > 0 and (t_p < 1).any()


@pytest.mark.parametrize("make", MAKES)
def test_culled_fwd_walk_matches_pallas(make):
    """The walk model against the JAX kernel in interpret mode."""
    rows, counts, tstart, toff = make()[:4]
    K = -(-int(counts.max()) // CHUNK) * CHUNK
    acc_j, t_j = jax_blend(rows, counts, tstart, toff, K)
    acc, t_final, _ = fwd_walk_model(rows, counts, tstart, toff, GRID_X, CHUNK)
    np.testing.assert_allclose(acc.numpy(), acc_j, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(t_final.numpy(), t_j, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("make", MAKES)
def test_fwd_bound_counts_the_culled_walks_evaluations(make):
    """count_work's "in_box" pairs, on which the bounds of K1 and K5 count
    an evaluation, are the pairs the culled forward walk evaluates; the
    cull leaves every pair that passes 1/255."""
    stream = make()[:4]
    _, _, n_eval = fwd_walk_model(*stream, GRID_X, CHUNK)
    *_, work = blend_stream_fwd_plain(*map(torch.as_tensor, stream), GRID_X, CHUNK,
                                      count_work=True)
    assert work["in_box"] == n_eval
    assert work["tested"] <= n_eval <= work["evaluated"]
    # flat splats (conic 0) are never culled; the others' boxes cull
    assert (n_eval == work["evaluated"]) == (make is make_flat_bwd_stream)


def test_culled_fwd_walk_over_a_dense_block():
    """K5's walk: the model over the dense block read as a strided stream
    (tile t at t * K, pixels of image tile t + tile_offset) gives
    blend_tiles_fwd_plain's outputs bit for bit and count_work's in_box
    pairs; the opaque splats in the block's dead rows are never read."""
    gdata, counts, _ = make_dense(C=7, tile_offset=4)
    g, c = torch.as_tensor(gdata), torch.as_tensor(counts)
    acc, t_final, n_eval = fwd_walk_model(*(x.numpy() for x in _strided(g, c, 4)),
                                          GRID_X, CHUNK)
    acc_p, t_p, work = blend_tiles_fwd_plain(g, c, GRID_X, CHUNK, 4, count_work=True)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)
    assert work["in_box"] == n_eval < work["evaluated"]
    assert (t_p[c == 0] == 1.0).all()
