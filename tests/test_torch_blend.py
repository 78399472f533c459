"""Kernel contract of the port's stream blend (K1).

One slot stream is built with numpy and blended by the JAX package's Pallas
kernel `blend_stream_pallas_fwd` (interpret mode on the CPU, as
tests/test_pallas.py runs it) and by the port's `blend_stream_fwd`, which on
a CPU tensor runs its plain PyTorch version. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py and by
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

from opengaussian_tpu.ops.rasterize_pallas import LANES, blend_stream_pallas_fwd
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_fwd,
    blend_stream_fwd_plain,
)
from tests.test_torch_gpu import CHUNK, GRID_X, make_stream

torch.set_num_threads(1)

def jax_blend(rows, counts, tstart, toff, K):
    P, F = rows.shape
    ids = np.arange(P, dtype=np.float32)[:, None]
    padded = np.zeros((P + K, LANES), np.float32)
    padded[:P, :F] = rows
    padded[:P, F:F + 1] = ids
    acc, t_final = blend_stream_pallas_fwd(
        jnp.asarray(padded), jnp.asarray(counts), jnp.asarray(tstart), GRID_X,
        CHUNK, K, F + 1, jnp.asarray(toff))
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


def numpy_work(rows, counts, tstart, toff):
    """The blend's work counts by a direct per-pixel walk in numpy: each
    tile's 256 pixels step through its run slot by slot, in float32."""
    n = dict(evaluated=0, tested=0, blended=0)
    lane = np.arange(256)
    for t in range(len(counts)):
        px = ((toff[t] % GRID_X) * 16 + lane % 16).astype(np.float32)
        py = ((toff[t] // GRID_X) * 16 + lane // 16).astype(np.float32)
        trans = np.ones(256, np.float32)
        live = np.ones(256, bool)
        for r in rows[tstart[t]:tstart[t] + counts[t]]:
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
