"""Kernel contracts of the port's stream blend (K1), its backward (K2) and
the per-splat reduce (K3).

One slot stream is built with numpy and goes through the JAX package's
Pallas kernels `blend_stream_pallas_fwd` / `blend_stream_pallas_bwd` /
`sorted_segment_reduce` (interpret mode on the CPU, as tests/test_pallas.py
runs them) and through the port's wrappers, which on a CPU tensor run their
plain PyTorch versions. The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py and by
tests/test_torch_gpu.py.

Traps to rule out before filing a mismatch as a fault:
  * Depth ties: the stream is taken as given here, so no sort is involved;
    the binning tests use well-separated depths.
  * Row layout: the JAX kernel reads lane-padded rows [P + K, 128] with the
    splat id as an extra f32 column and K rows of zero padding; the port
    reads [P, 6 + C] rows and only each tile's own run.
  * Thresholds: the JAX kernel forms the transmittance as a shift-doubling
    product within a chunk, the port as a running product, so a pixel whose
    T lands within an ulp of 1e-4 could stop one slot apart. The fixtures
    here do not put any pixel that close.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops.rasterize_pallas import (
    LANES,
    WSEG,
    blend_stream_pallas_bwd,
    blend_stream_pallas_fwd,
    sorted_segment_reduce,
)
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_bwd,
    blend_stream_bwd_plain,
    blend_stream_fwd,
    blend_stream_fwd_plain,
    segment_reduce,
    segment_reduce_plain,
    slot_box_plain,
)
from tests.test_torch_gpu import CHUNK, GRID_X, make_bwd_stream, make_stream

torch.set_num_threads(1)


def _padded(rows, K):
    """The JAX kernels' layout: lane-padded rows with the slot id as an
    extra f32 column and K rows of zero padding."""
    P, F = rows.shape
    padded = np.zeros((P + K, LANES), np.float32)
    padded[:P, :F] = rows
    padded[:P, F] = np.arange(P, dtype=np.float32)
    return jnp.asarray(padded)


def jax_blend(rows, counts, tstart, toff, K):
    acc, t_final = blend_stream_pallas_fwd(
        _padded(rows, K), jnp.asarray(counts), jnp.asarray(tstart), GRID_X,
        CHUNK, K, rows.shape[1] + 1, jnp.asarray(toff))
    return np.asarray(acc), np.asarray(t_final)


def test_plain_blend_matches_pallas():
    rows, counts, tstart, toff = make_stream()
    acc_j, t_j = jax_blend(rows, counts, tstart, toff, K=160)
    acc_t, t_t = blend_stream_fwd(*map(torch.as_tensor, (rows, counts, tstart, toff)),
                                  GRID_X, CHUNK)
    assert acc_t.shape == (12, 4, 256) and t_t.shape == (12, 256)
    np.testing.assert_allclose(acc_t.numpy(), acc_j, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), t_j, atol=3e-5, rtol=1e-4)
    # the fixture exercises what it claims
    t_np = t_t.numpy()
    assert (t_np[0] > 1e-4).all() and (t_np[0] < 0.01).all()  # tile 0 stopped
    assert (t_np[counts == 0] == 1.0).all()  # empty tiles untouched
    assert (acc_t.numpy()[counts == 0] == 0.0).all()


def test_plain_blend_chunk_invariant():
    """The chunk only sets how many rows are staged per step: any chunk
    gives the same sequential walk, bit for bit."""
    args = tuple(map(torch.as_tensor, make_stream(seed=1)))
    ref = blend_stream_fwd_plain(*args, GRID_X, 7)
    for chunk in (1, 32, 256):
        out = blend_stream_fwd_plain(*args, GRID_X, chunk)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def numpy_work(rows, counts, tstart, toff, chunk=CHUNK):
    """The blend's work counts by a direct per-pixel walk in numpy: each
    tile's 256 pixels step through its run slot by slot, in float32. A
    chunk of slots is staged (one cull box per slot, one box test per slot
    and warp) while any pixel of the tile is live; a live pixel's pair is
    in the box when its warp's 16 x 2 rectangle meets the slot's box."""
    n = dict(evaluated=0, in_box=0, tested=0, blended=0, boxes=0, box_tests=0)
    boxes = slot_box_plain(torch.as_tensor(rows)).numpy()
    lane = np.arange(256)
    for t in range(len(counts)):
        px = ((toff[t] % GRID_X) * 16 + lane % 16).astype(np.float32)
        py = ((toff[t] // GRID_X) * 16 + lane // 16).astype(np.float32)
        rx0 = np.float32((toff[t] % GRID_X) * 16)
        ry0 = ((toff[t] // GRID_X) * 16 + 2 * np.arange(8)).astype(np.float32)
        trans = np.ones(256, np.float32)
        live = np.ones(256, bool)
        for k, r in enumerate(rows[tstart[t]:tstart[t] + counts[t]]):
            if k % chunk == 0 and live.any():
                staged = min(chunk, counts[t] - k)
                n["boxes"] += staged
                n["box_tests"] += 8 * staged
            b = boxes[tstart[t] + k]
            meets = ~((rx0 + 15 < b[0]) | (rx0 > b[1]) | (ry0 + 1 < b[2]) | (ry0 > b[3]))
            n["in_box"] += int((live & meets[lane // 32]).sum())
            dx, dy = r[0] - px, r[1] - py
            power = np.float32(-0.5) * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy
            a = np.minimum(np.where(power <= 0, r[5] * np.exp(np.minimum(power, 0)), 0),
                           np.float32(0.99))
            tested = live & (a >= np.float32(1 / 255))
            t_next = trans * (np.float32(1) - a)
            stop = tested & (t_next < np.float32(1e-4))
            blended = tested & ~stop
            n["evaluated"] += int(live.sum())
            n["tested"] += int(tested.sum())
            n["blended"] += int(blended.sum())
            trans = np.where(blended, t_next, trans)
            live &= ~stop
    return n


def test_plain_blend_work_counts():
    """count_work gives the pairs this stream's data needs, as the direct
    walk counts them, and leaves the blend itself unchanged."""
    stream = make_stream(seed=2)
    args = tuple(map(torch.as_tensor, stream))
    acc, t_final, work = blend_stream_fwd_plain(*args, GRID_X, CHUNK, count_work=True)
    ref = blend_stream_fwd_plain(*args, GRID_X, CHUNK)
    assert torch.equal(acc, ref[0]) and torch.equal(t_final, ref[1])
    assert work == numpy_work(*stream)
    rows, counts = stream[:2]
    assert 0 < work["blended"] < work["tested"] < work["evaluated"] < 256 * counts.sum()
    # the box is conservative and culls: every pair past 1/255 lies in it
    assert work["tested"] <= work["in_box"] < work["evaluated"]
    assert 0 < work["boxes"] <= counts.sum() and work["box_tests"] == 8 * work["boxes"]


def test_blend_wrapper_validates_inputs():
    rows, counts, tstart, toff = map(torch.as_tensor, make_stream())
    with pytest.raises(ValueError, match="rows must be float32"):
        blend_stream_fwd(rows.double(), counts, tstart, toff, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="counts must be int32"):
        blend_stream_fwd(rows, counts.long(), tstart, toff, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="toff must be int32"):
        blend_stream_fwd(rows, counts, tstart, toff[:-1], GRID_X, CHUNK)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        blend_stream_fwd(rows.t().contiguous().t(), counts, tstart, toff, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="chunk"):
        blend_stream_fwd(rows, counts, tstart, toff, GRID_X, 0)


def test_plain_bwd_matches_pallas():
    """K2: the JAX kernel's dense [T, K, F + 1] rows, moved to stream order
    by tstart, against the port's stream-order rows [P, F]."""
    rows, counts, tstart, toff, acc, t_final, g_acc, g_t = make_bwd_stream()
    K, F = 160, rows.shape[1]
    d = np.asarray(blend_stream_pallas_bwd(
        _padded(rows, K), jnp.asarray(counts), jnp.asarray(tstart),
        jnp.asarray(acc), jnp.asarray(t_final), jnp.asarray(g_acc), jnp.asarray(g_t),
        GRID_X, CHUNK, K, F + 1, jnp.asarray(toff)))
    want = np.zeros_like(rows)
    for t in range(len(counts)):
        want[tstart[t]:tstart[t] + counts[t]] = d[t, :counts[t], :F]
    got = blend_stream_bwd(*map(torch.as_tensor, (rows, counts, tstart, toff, acc,
                                                  t_final, g_acc, g_t)),
                           GRID_X, CHUNK)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    # the fixture exercises what it claims: tile 0 stops early, so the rest
    # of its run has no gradient; tile 7 holds alphas clamped at 0.99
    live = np.abs(want[:counts[0]]).sum(1) > 0
    assert live[:5].all() and not live[-20:].any()
    lane = np.arange(256)
    px = (toff[7] % GRID_X) * 16 + lane % 16
    py = (toff[7] // GRID_X) * 16 + lane // 16
    r = rows[tstart[7]:tstart[7] + 5]
    dx, dy = r[:, :1] - px, r[:, 1:2] - py
    power = -0.5 * (r[:, 2:3] * dx * dx + r[:, 4:5] * dy * dy) - r[:, 3:4] * dx * dy
    assert (np.exp(np.minimum(power, 0)) >= 0.99).any()
    assert np.abs(got.numpy()).max() > 10.0


def test_plain_bwd_chunk_invariant():
    args = tuple(map(torch.as_tensor, make_bwd_stream(seed=1)))
    ref = blend_stream_bwd_plain(*args, GRID_X, 7)
    for chunk in (1, 32, 256):
        assert torch.equal(blend_stream_bwd_plain(*args, GRID_X, chunk), ref)


def test_plain_bwd_work_counts_match_forward():
    """The replay walks exactly the forward's pairs."""
    stream = make_bwd_stream(seed=2)
    args = tuple(map(torch.as_tensor, stream))
    _, work = blend_stream_bwd_plain(*args, GRID_X, CHUNK, count_work=True)
    assert work == numpy_work(*stream[:4])


@pytest.mark.parametrize("R,n", [(3000, 700), (5000, WSEG * 2), (2000, 33)])
def test_plain_reduce_matches_pallas(R, n):
    """K3 at tests/test_pallas.py's shapes: ids equal to n are dropped, ids
    on the JAX kernel's window edges are summed like any other."""
    rng = np.random.default_rng(5)
    rows = rng.normal(0, 1, (R, 11)).astype(np.float32)
    ids = rng.integers(0, n + 1, R)
    ids[:50] = np.clip([0, n - 1, WSEG - 1, WSEG, n], 0, n)[rng.integers(0, 5, 50)]
    ids = ids.astype(np.int32)
    want = np.asarray(sorted_segment_reduce(jnp.asarray(rows), jnp.asarray(ids), n))
    got = segment_reduce(torch.as_tensor(rows), torch.as_tensor(ids), n)
    assert got.shape == (n, 11)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert (ids == n).any()


def test_reduce_wrapper_validates_inputs():
    rows = torch.zeros((4, 3))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids must be int32"):
        segment_reduce(rows, ids.long(), 2)
    with pytest.raises(ValueError, match="rows must be float32"):
        segment_reduce(rows.double(), ids, 2)
    assert torch.equal(segment_reduce_plain(rows + 1, ids - 1, 2), torch.zeros(2, 3))


def test_bwd_wrapper_validates_inputs():
    rows, counts, tstart, toff, acc, t_final, g_acc, g_t = map(
        torch.as_tensor, make_bwd_stream())
    with pytest.raises(ValueError, match="g_accum must be float32"):
        blend_stream_bwd(rows, counts, tstart, toff, acc, t_final, g_acc[:, :2],
                         g_t, GRID_X, CHUNK)
    with pytest.raises(ValueError, match="t_final must be contiguous"):
        blend_stream_bwd(rows, counts, tstart, toff, acc, t_final.t().contiguous().t(),
                         g_acc, g_t, GRID_X, CHUNK)
