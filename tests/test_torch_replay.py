"""Plain models of the redesigned backward replay (csrc/blend_tile.cuh:
blend_run_bwd, the walk of K2, K4 and K6), held against the plain version
of K2 and the JAX package's kernel.

The CUDA kernel runs only on the card; what it changes in the walk is
modelled here in plain numpy and PyTorch, with the kernel's fp32 arithmetic:
  * the reduce-scatter butterfly that sums a slot's fields over a warp must
    give the shuffle-down tree's sums (`_lane_tree_sum`) bit for bit;
  * the cull box of a slot (`slot_box_plain`) must be conservative: no
    pixel of a 16x2 warp rectangle it culls reaches alpha >= 1/255 under
    the walk's own `_chunk_alpha`;
  * the walk with the cull and the butterfly must give
    `blend_stream_bwd_plain`'s rows bit for bit, and the JAX package's
    `blend_stream_pallas_bwd` (interpret mode) within the usual tolerance;
  * the walk by mask bits, in which a warp writes no partial for a slot it
    skips and the row adds only the set warps' partials (+ 0 once where a
    warp skipped), must give the rows of the walk that adds every warp's
    partial, zero or not, bit for bit with the sign of every zero (the trap:
    partials of -0 in some warps, none in others), and so the plain
    version's;
  * the evaluations the culled walk makes are the "in_box" pairs that
    count_work reports, on which chip_smoke.py bases the kernels' bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from opengaussian_tpu.ops.rasterize_pallas import blend_stream_pallas_bwd
from opengaussian_tpu_torch.ops import blend
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    NPIX,
    WARP,
    _chunk_alpha,
    _lane_tree_sum,
    _pixels,
    blend_stream_bwd_plain,
    slot_box_plain,
)
from tests.test_torch_blend import _padded
from tests.test_torch_gpu import (
    CHUNK,
    GRID_X,
    make_bwd_stream,
    make_deep_bwd_stream,
    make_flat_bwd_stream,
    make_zero_sign_bwd_stream,
)

torch.set_num_threads(1)

F32 = np.float32
ALPHA_MIN = F32(blend.ALPHA_MIN)
INF = F32(np.inf)


def reduce_scatter(v: np.ndarray) -> np.ndarray:
    """blend_tile.cuh:reduce_scatter over the 32 lanes of a warp.
    v [32, N] f32 (N = 16 or 32), lane by value. -> [32] f32: lane l's v[0]
    at the end, the warp's sum of value l >> 1 (N = 16) or l (N = 32)."""
    v = v.astype(F32).copy()
    lanes = np.arange(WARP)
    n = v.shape[1]
    for off in (16, 8, 4, 2, 1):
        partner = lanes ^ off
        if n > 1:
            h = n // 2
            up = ((lanes & off) != 0)[:, None]
            send = np.where(up, v[:, :h], v[:, h:n])
            keep = np.where(up, v[:, h:n], v[:, :h])
            v[:, :h] = keep + send[partner]
            n = h
        else:
            v[:, 0] = v[:, 0] + v[partner, 0]
    return v[:, 0]


def warp_partial(vals: np.ndarray) -> np.ndarray:
    """One warp's sum of vals [F, 32] f32 over its lanes: the butterfly over
    the fields padded to 16 (or 32). -> [F] f32."""
    F = vals.shape[0]
    nv = 16 if F <= 16 else 32
    v = np.zeros((WARP, nv), F32)
    v[:, :F] = vals.T
    out = reduce_scatter(v)
    lanes = np.arange(WARP)
    held = lanes >> 1 if nv == 16 else lanes
    part = np.zeros(F, F32)
    for f in range(F):
        where = lanes[held == f]
        assert (out[where].view(np.uint32) == out[where[0]].view(np.uint32)).all()
        part[f] = out[where[0]]
    return part


def warp_sums(vals: np.ndarray) -> np.ndarray:
    """The kernel's sum over a tile's pixels of vals [F, 256] f32: each
    warp's butterfly over its fields padded to 16 (or 32), then the 8 warps'
    partials in warp order. -> [F] f32."""
    total = None
    for w in range(NPIX // WARP):
        part = warp_partial(vals[:, w * WARP:(w + 1) * WARP])
        total = part if total is None else total + part
    return total


def bits(x) -> np.ndarray:
    return np.asarray(x, F32).view(np.uint32)


@pytest.mark.parametrize("F", [10, 13, 22])
def test_butterfly_equals_the_shuffle_tree_bitwise(F):
    """Per-warp and per-tile sums of fields with near-cancelling terms (big
    values of both signs plus small ones, signed zeros) equal
    _lane_tree_sum's bit for bit."""
    rng = np.random.default_rng(F)
    for trial in range(20):
        big = rng.choice([-1, 1], (F, NPIX)) * rng.uniform(1e3, 1e4, (F, NPIX))
        small = rng.normal(0, 1e-3, (F, NPIX))
        vals = np.where(rng.uniform(size=(F, NPIX)) < 0.5, big, small).astype(F32)
        if trial % 2:  # neighbours cancel to a few ulp
            vals[:, 1::2] = -vals[:, 0::2] * (1 + rng.normal(0, 1e-6, (F, NPIX // 2)))
        vals[rng.uniform(size=vals.shape) < 0.2] = 0.0
        vals[rng.uniform(size=vals.shape) < 0.05] = -0.0
        want = _lane_tree_sum(torch.as_tensor(vals)).numpy()
        assert (bits(warp_sums(vals)) == bits(want)).all()


def slot_box(g: np.ndarray) -> np.ndarray:
    """blend_tile.cuh:slot_box by its plain version (the kernel's fp32
    arithmetic), on numpy rows g [S, >=6] f32. -> [S, 4] f32 boxes (x0, x1,
    y0, y1)."""
    return slot_box_plain(torch.as_tensor(np.asarray(g, F32))).numpy()


def culled(box: np.ndarray, ox, oy) -> np.ndarray:
    """Which of the 8 warps of the tile whose top-left pixel is (ox, oy)
    skip the slot of `box`. -> [8] bool."""
    rx0, rx1 = F32(ox), F32(ox + 15)
    ry0 = (oy + 2 * np.arange(NPIX // WARP)).astype(F32)
    ry1 = ry0 + F32(1)
    return (rx1 < box[0]) | (rx0 > box[1]) | (ry1 < box[2]) | (ry0 > box[3])


def alpha_at(row: np.ndarray, origins) -> np.ndarray:
    """_chunk_alpha of one slot at the 256 pixels of each tile whose
    top-left pixel is in origins [(ox, oy), ...]. -> [n, 256] f32, 0 where
    the slot falls below 1/255."""
    n = len(origins)
    lane = np.arange(NPIX)
    px = np.array([ox + lane % 16 for ox, _ in origins], F32)[:, None, :]
    py = np.array([oy + lane // 16 for _, oy in origins], F32)[:, None, :]
    rows = torch.as_tensor(np.asarray(row, F32)[None, :])
    counts = torch.ones(n, dtype=torch.int64)
    start = torch.zeros(n, dtype=torch.int64)
    a = _chunk_alpha(rows, counts, start, 0, 1, torch.as_tensor(px), torch.as_tensor(py))[-1]
    return a[:, 0].numpy()


def edge_origins(box, row):
    """Tile origins that put one of its warps' rectangles just outside each
    edge of the box, level with the ellipse's extreme point on that side,
    and one tile over the slot's mean."""
    mx, my, ca, cb, cc = (float(x) for x in row[:5])
    x0, x1, y0, y1 = (float(x) for x in box)
    sx, sy = (cb / cc * (x1 - x0) / 2, cb / ca * (y1 - y0) / 2) if ca and cc else (0, 0)
    out = [(np.floor(mx) - 7, np.floor(my) - 7)]
    for w in (0, 1, 7):  # the warp whose rectangle sits at the edge
        out += [(np.floor(x1) + 1, np.floor(my - sx) - 2 * w),  # right of the box
                (np.ceil(x0) - 16, np.floor(my + sx) - 2 * w),  # left
                (np.floor(mx - sy) - 7, np.floor(y1) + 1 - 2 * w),  # below
                (np.floor(mx + sy) - 7, np.ceil(y0) - 2 - 2 * w)]  # above
    return [(int(ox), int(oy)) for ox, oy in out]


def ulps_from(x: np.float32, k: int) -> np.float32:
    for _ in range(abs(k)):
        x = np.nextafter(x, F32(np.sign(k) * INF))
    return x


conic_entry = st.floats(-6.0, 4.0).map(lambda e: 10.0 ** e)


@st.composite
def slots(draw):
    """A slot row: mean anywhere on a wide frame, a conic from tiny to huge
    (correlation up to +-1: near-degenerate), opacity uniform, at 1/255 or a
    few ulp around it."""
    mx = draw(st.floats(-60.0, 1400.0))
    my = draw(st.floats(-60.0, 1000.0))
    a, c = draw(conic_entry), draw(conic_entry)
    rho = draw(st.one_of(st.floats(-0.999999, 0.999999), st.sampled_from([0.0, 1.0, -1.0])))
    b = rho * np.sqrt(a * c)
    k = draw(st.integers(-2, 2))
    o = draw(st.one_of(st.floats(0.0, 1.0), st.just(float(ulps_from(ALPHA_MIN, k)))))
    return np.array([mx, my, a, b, c, o, 0.5], F32)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(slots())
def test_cull_box_is_conservative(row):
    """No pixel of a warp rectangle the box culls reaches alpha >= 1/255."""
    box = slot_box(row[None])[0]
    if not np.isfinite(box).all() and box[0] < box[1]:
        return  # unbounded: the slot is never culled
    if box[0] > box[1]:  # empty: opacity below 1/255, alpha never passes
        assert row[5] < ALPHA_MIN
        origins = [(int(row[0]) - 8, int(row[1]) - 8)]
    else:
        origins = edge_origins(box, row)
    a = alpha_at(row, origins)
    for (ox, oy), ai in zip(origins, a):
        cut = np.repeat(culled(box, ox, oy), WARP)
        assert not (ai[cut] >= ALPHA_MIN).any(), (row, box, (ox, oy))


def test_cull_box_is_tight_for_typical_splats():
    """For splats like a frame's (conic entries 0.01..1, correlation up to
    0.9, opacity 0.05..0.99) the box is the ellipse alpha = 1/255 widened by
    its stated factor 1 / sqrt(1 - r), r = 1e-6 kappa, to within 1/32 pixel:
    the cull removes the pairs it should."""
    rng = np.random.default_rng(0)
    n = 400
    a, c = 10 ** rng.uniform(-2, 0, n), 10 ** rng.uniform(-2, 0, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    o = rng.uniform(0.05, 0.99, n)
    rows = np.stack([rng.uniform(0, 1000, n), rng.uniform(0, 700, n), a, b, c, o,
                     np.zeros(n)], -1).astype(F32)
    a, b, c, o = (rows[:, i].astype(np.float64) for i in (2, 3, 4, 5))
    box = slot_box(rows)
    det = a * c - b * b
    r = 1e-6 * (np.maximum(a, c) + np.abs(b)) * (a + c) / det
    assert (r <= 0.5).all() and np.isfinite(box).all()
    grow = np.sqrt(2 * np.log(o * 255.0) / (1 - r) / det)
    assert np.allclose((box[:, 1] - box[:, 0]) / 2, grow * np.sqrt(c), atol=1 / 32, rtol=1e-3)
    assert np.allclose((box[:, 3] - box[:, 2]) / 2, grow * np.sqrt(a), atol=1 / 32, rtol=1e-3)


def walk_model(rows, counts, tstart, toff, acc, t_final, g_acc, g_t, grid_x: int,
               chunk: int) -> tuple[torch.Tensor, int]:
    """The redesigned walk in plain PyTorch, one tile (CTA) at a time, chunk
    by chunk until every pixel stopped: a warp whose rectangle misses a
    slot's box does not evaluate it, and each row is the warps' butterfly
    sums added in warp order. Per-pixel arithmetic as in
    blend_stream_bwd_plain. -> (d_rows [P, F], the (slot, pixel) pairs
    evaluated)."""
    rows_t = torch.as_tensor(rows)
    P, F = rows.shape
    C = F - 6
    d = torch.zeros((P, F), dtype=torch.float32)
    n_eval = 0
    boxes = slot_box(rows)
    px, py = (x[:, 0] for x in _pixels(torch.as_tensor(toff), grid_x, "cpu"))
    g_acc, acc = torch.as_tensor(g_acc), torch.as_tensor(acc)
    floor = 1.0 - blend.ALPHA_MAX
    for t in range(len(counts)):
        cnt, t0 = int(counts[t]), int(tstart[t])
        ox, oy = int(toff[t] % grid_x) * 16, int(toff[t] // grid_x) * 16
        ga_total = g_acc[t, 0] * acc[t, 0]
        for c in range(1, C):
            ga_total = ga_total + g_acc[t, c] * acc[t, c]
        gtt = torch.as_tensor(g_t[t]) * torch.as_tensor(t_final[t])
        trans = torch.ones(NPIX)
        bacc = torch.zeros(NPIX)
        done = torch.zeros(NPIX, dtype=torch.bool)
        for base in range(0, cnt, chunk):
            if bool(done.all()):
                break
            for k in range(base, min(base + chunk, cnt)):
                g = rows_t[t0 + k]
                skip = torch.as_tensor(np.repeat(culled(boxes[t0 + k], ox, oy), WARP))
                n_eval += int((~skip & ~done).sum())
                dx, dy = g[0] - px[t], g[1] - py[t]
                power = -0.5 * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy
                gauss = torch.exp(torch.clamp(power, max=0.0))
                araw = torch.where(power <= 0.0, g[5] * gauss, 0.0)
                a = torch.clamp(araw, max=blend.ALPHA_MAX)
                a = torch.where((a >= blend.ALPHA_MIN) & ~skip & ~done, a, 0.0)
                t_next = trans * (1.0 - a)
                stop = (a > 0.0) & (t_next < blend.T_EPS)
                contrib = (a > 0.0) & ~stop
                w = torch.where(contrib, a * trans, 0.0)
                gc = g[6] * g_acc[t, 0]
                for c in range(1, C):
                    gc = gc + g[6 + c] * g_acc[t, c]
                bacc = torch.where(contrib, bacc + w * gc, bacc)
                one_m_a = torch.clamp(1.0 - a, min=floor)
                d_alpha = trans * gc - (ga_total - bacc) / one_m_a - gtt / one_m_a
                d_alpha = torch.where(araw < blend.ALPHA_MAX, d_alpha, 0.0)
                d_power = a * d_alpha
                vals = torch.stack(
                    [d_power * -(g[2] * dx + g[3] * dy),
                     d_power * -(g[4] * dy + g[3] * dx),
                     d_power * (-0.5 * dx * dx), d_power * (-dx * dy),
                     d_power * (-0.5 * dy * dy), d_alpha * gauss]
                    + [w * g_acc[t, c] for c in range(C)])
                vals = torch.where(contrib, vals, 0.0).numpy()
                d[t0 + k] = torch.as_tensor(warp_sums(vals))
                trans = torch.where(contrib, t_next, trans)
                done = done | stop
    return d, n_eval


@pytest.mark.parametrize("make", [make_bwd_stream, make_deep_bwd_stream,
                                  make_flat_bwd_stream])
def test_culled_walk_equals_plain_bitwise(make):
    """The walk with the warp cull and the butterfly: the rows of
    blend_stream_bwd_plain, bit for bit (zeros compared as equal whatever
    their sign, as torch.equal does), on runs of several chunks, on a tile
    whose pixels all stop early, on a run of over ten chunks and on flat
    opaque splats."""
    stream = make()
    assert stream[1].max() > CHUNK
    got, _ = walk_model(*stream, GRID_X, CHUNK)
    want = blend_stream_bwd_plain(*map(torch.as_tensor, stream), GRID_X, CHUNK)
    assert torch.equal(got, want)
    assert want.abs().max() > 0


@pytest.mark.parametrize("make", [make_bwd_stream, make_deep_bwd_stream,
                                  make_flat_bwd_stream])
def test_bound_counts_the_culled_walks_evaluations(make):
    """count_work's "in_box" pairs, on which the bounds of K1, K2, K4, K5
    and K6 count an evaluation, are the pairs the culled walk evaluates;
    the cull leaves every pair that passes 1/255."""
    stream = make()
    _, n_eval = walk_model(*stream, GRID_X, CHUNK)
    _, work = blend_stream_bwd_plain(*map(torch.as_tensor, stream), GRID_X, CHUNK,
                                     count_work=True)
    assert work["in_box"] == n_eval
    assert work["tested"] <= n_eval <= work["evaluated"]
    # flat splats (conic 0) are never culled; the others' boxes cull
    assert (n_eval == work["evaluated"]) == (make is make_flat_bwd_stream)


def test_culled_walk_matches_pallas():
    """The walk model against the JAX kernel in interpret mode, on the
    stream whose tile 0 (150 slots, all pixels stopping early) and tile 7
    (96, alphas clamped at 0.99) span several chunks."""
    stream = make_bwd_stream()
    rows, counts, tstart, toff, acc, t_final, g_acc, g_t = stream
    K, F = 160, rows.shape[1]
    d = np.asarray(blend_stream_pallas_bwd(
        _padded(rows, K), jnp.asarray(counts), jnp.asarray(tstart),
        jnp.asarray(acc), jnp.asarray(t_final), jnp.asarray(g_acc), jnp.asarray(g_t),
        GRID_X, CHUNK, K, F + 1, jnp.asarray(toff)))
    want = np.zeros_like(rows)
    for t in range(len(counts)):
        want[tstart[t]:tstart[t] + counts[t]] = d[t, :counts[t], :F]
    got, _ = walk_model(*stream, GRID_X, CHUNK)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


def bit_walk_model(rows, counts, tstart, toff, acc, t_final, g_acc, g_t, grid_x: int,
                   chunk: int) -> tuple[torch.Tensor, dict]:
    """blend_tile.cuh:blend_run_bwd as it walks by mask bits, in plain numpy
    and PyTorch, one tile (CTA) at a time, chunk by chunk until every pixel
    stopped. Per chunk, one bit per (warp, slot): the warp's rectangle meets
    the slot's box. Per slot, each warp whose bit is set evaluates its
    pixels that have not stopped (walk_model's arithmetic); if none of them
    composites the slot, it clears its bit and writes no partial, else its
    partial is its butterfly sum. The row is the set warps' partials added
    in warp order, + 0 once if some warp's bit is clear, +0 if none is set.
    -> (d_rows [P, F], {"flipped": fields whose set warps summed to -0 and
    took the + 0, "kept": fields that all 8 warps summed to -0})."""
    rows_t = torch.as_tensor(rows)
    P, F = rows.shape
    C = F - 6
    W = NPIX // WARP
    d = np.zeros((P, F), F32)
    trap = {"flipped": 0, "kept": 0}
    boxes = slot_box(rows)
    px, py = (x[:, 0] for x in _pixels(torch.as_tensor(toff), grid_x, "cpu"))
    g_acc, acc = torch.as_tensor(g_acc), torch.as_tensor(acc)
    floor = 1.0 - blend.ALPHA_MAX
    for t in range(len(counts)):
        cnt, t0 = int(counts[t]), int(tstart[t])
        ox, oy = int(toff[t] % grid_x) * 16, int(toff[t] // grid_x) * 16
        ga_total = g_acc[t, 0] * acc[t, 0]
        for c in range(1, C):
            ga_total = ga_total + g_acc[t, c] * acc[t, c]
        gtt = torch.as_tensor(g_t[t]) * torch.as_tensor(t_final[t])
        trans = torch.ones(NPIX)
        bacc = torch.zeros(NPIX)
        done = torch.zeros(NPIX, dtype=torch.bool)
        for base in range(0, cnt, chunk):
            if bool(done.all()):
                break
            for k in range(base, min(base + chunk, cnt)):
                g = rows_t[t0 + k]
                bit = ~culled(boxes[t0 + k], ox, oy)  # [W]
                lane_bit = torch.as_tensor(np.repeat(bit, WARP))
                dx, dy = g[0] - px[t], g[1] - py[t]
                power = -0.5 * (g[2] * dx * dx + g[4] * dy * dy) - g[3] * dx * dy
                gauss = torch.exp(torch.clamp(power, max=0.0))
                araw = torch.where(power <= 0.0, g[5] * gauss, 0.0)
                a = torch.clamp(araw, max=blend.ALPHA_MAX)
                a = torch.where((a >= blend.ALPHA_MIN) & lane_bit & ~done, a, 0.0)
                t_next = trans * (1.0 - a)
                stop = (a > 0.0) & (t_next < blend.T_EPS)
                contrib = (a > 0.0) & ~stop
                w = torch.where(contrib, a * trans, 0.0)
                gc = g[6] * g_acc[t, 0]
                for c in range(1, C):
                    gc = gc + g[6 + c] * g_acc[t, c]
                bacc = torch.where(contrib, bacc + w * gc, bacc)
                one_m_a = torch.clamp(1.0 - a, min=floor)
                d_alpha = trans * gc - (ga_total - bacc) / one_m_a - gtt / one_m_a
                d_alpha = torch.where(araw < blend.ALPHA_MAX, d_alpha, 0.0)
                d_power = a * d_alpha
                vals = torch.stack(
                    [d_power * -(g[2] * dx + g[3] * dy),
                     d_power * -(g[4] * dy + g[3] * dx),
                     d_power * (-0.5 * dx * dx), d_power * (-dx * dy),
                     d_power * (-0.5 * dy * dy), d_alpha * gauss]
                    + [w * g_acc[t, c] for c in range(C)])
                vals = torch.where(contrib, vals, 0.0).numpy()
                who = contrib.numpy().reshape(W, WARP).any(axis=1)
                kept = [wi for wi in range(W) if bit[wi] and who[wi]]
                if kept:
                    s = warp_partial(vals[:, kept[0] * WARP:(kept[0] + 1) * WARP])
                    for wi in kept[1:]:
                        s = s + warp_partial(vals[:, wi * WARP:(wi + 1) * WARP])
                    neg = (s == 0) & np.signbit(s)
                    if len(kept) < W:
                        trap["flipped"] += int(neg.sum())
                        s = s + F32(0.0)
                    else:
                        trap["kept"] += int(neg.sum())
                    d[t0 + k] = s
                trans = torch.where(contrib, t_next, trans)
                done = done | stop
    return torch.as_tensor(d), trap


@pytest.mark.parametrize("make", [make_bwd_stream, make_deep_bwd_stream,
                                  make_flat_bwd_stream, make_zero_sign_bwd_stream])
def test_bit_walk_equals_the_full_sum_bitwise(make):
    """The walk by mask bits, with its sum over the set warps only: the rows
    of the walk that adds all 8 warps' partials, bit for bit with the sign
    of every zero, and so blend_stream_bwd_plain's (zeros compared as equal
    whatever their sign, as torch.equal does), on runs of several chunks, of
    over ten chunks, of flat opaque splats, and on the zero-sign fixture,
    whose -0 partials meet both sides of the trap."""
    stream = make()
    got, trap = bit_walk_model(*stream, GRID_X, CHUNK)
    full, _ = walk_model(*stream, GRID_X, CHUNK)
    assert (bits(got.numpy()) == bits(full.numpy())).all()
    want = blend_stream_bwd_plain(*map(torch.as_tensor, stream), GRID_X, CHUNK)
    assert torch.equal(got, want) and want.abs().max() > 0
    if make is make_zero_sign_bwd_stream:
        assert trap["flipped"] > 0 and trap["kept"] > 0
        assert (bits(full.numpy()[:, 6]) == bits(-0.0)).any()
