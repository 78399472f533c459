"""The port's CUDA kernels on the card, against their plain versions.

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(--noconftest skips tests/conftest.py, which pins JAX to the CPU). Each
test skips where torch.cuda.is_available() is false. The stream fixture
`make_stream` is shared with tests/test_torch_blend.py, the backward ones
(`make_bwd_stream`, `make_deep_bwd_stream`, `make_flat_bwd_stream`) with
tests/test_torch_replay.py and tests/test_torch_fwd_walk.py, the dense one
`make_dense` (with `dense_starts`) with tests/test_torch_dense.py and
tests/test_torch_fwd_walk.py.
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
    compact_rows,
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
    return with_cotangents(rows, counts, tstart, toff, seed)


def with_cotangents(rows, counts, tstart, toff, seed):
    """A stream with its forward outputs (plain version) and cotangents
    ~ N(0, 0.1^2) seeded from seed + 100."""
    acc, t_final = blend_stream_fwd_plain(
        *map(torch.as_tensor, (rows, counts, tstart, toff)), GRID_X, CHUNK)
    rng = np.random.default_rng(seed + 100)
    g_acc = rng.normal(0, 0.1, size=acc.shape).astype(np.float32)
    g_t = rng.normal(0, 0.1, size=t_final.shape).astype(np.float32)
    return rows, counts, tstart, toff, acc.numpy(), t_final.numpy(), g_acc, g_t


def make_deep_bwd_stream(seed=0, C=4, depth=10 * CHUNK + 7):
    """make_bwd_stream's stream with a run of `depth` slots, over ten chunks
    and over the 256 threads of a CTA, appended for the empty tile 2: faint splats
    (opacity 0.003-0.04, some below 1/255), so most of its pixels stay live
    to the end, and eight small opaque ones a third of the way down, which
    stop the pixels near their centers. -> as make_bwd_stream."""
    rows, counts, tstart, toff = make_stream(seed, C)
    rows[tstart[7]:tstart[7] + 5, 5] = 1.0
    rng = np.random.default_rng(seed + 200)
    ox, oy = (toff[2] % GRID_X) * 16, (toff[2] // GRID_X) * 16
    mean = np.stack([ox + rng.uniform(-4, 20, depth), oy + rng.uniform(-4, 20, depth)], -1)
    a = rng.uniform(0.005, 0.08, depth)
    c = rng.uniform(0.005, 0.08, depth)
    b = rng.uniform(-0.5, 0.5, depth) * np.sqrt(a * c)
    opac = rng.uniform(0.003, 0.04, depth)
    stop = depth // 3 + np.arange(8)
    a[stop], c[stop], b[stop], opac[stop] = 0.5, 0.5, 0.0, 0.99
    deep = np.concatenate([mean, a[:, None], b[:, None], c[:, None], opac[:, None],
                           rng.uniform(0, 1, (depth, C))], -1).astype(np.float32)
    tstart[2], counts[2] = rows.shape[0], depth
    return with_cotangents(np.concatenate([rows, deep]), counts, tstart, toff, seed)


def make_flat_bwd_stream(seed=0, C=4):
    """make_bwd_stream's stream made of flat opaque splats (conic 0, opacity
    0.98): every pixel of a tile stops at its third slot, so each tile's
    walk ends after its first chunk. -> as make_bwd_stream."""
    rows, counts, tstart, toff = make_stream(seed, C)
    rows[:, 2:5] = 0.0
    rows[:, 5] = 0.98
    return with_cotangents(rows, counts, tstart, toff, seed)


def make_zero_sign_bwd_stream(seed=0, C=4):
    """make_stream's stream with three slots put at the front of every
    non-empty run, and the cotangent of payload channel 0 set to -0 at every
    pixel, so that each pixel compositing a slot gives that field -0 and a
    warp whose 32 pixels all composite it sums to -0: a band over tile rows
    0-7 (warps 0-3 composite it, the rest of the warps do not), a wide splat
    that every pixel composites (all 8 warps sum to -0), and a band over rows
    10-15 (warps 5-7). -> as make_bwd_stream."""
    rows, counts, tstart, toff = make_stream(seed, C)
    runs, new_counts = [], counts.copy()
    for t in range(len(counts)):
        run = rows[tstart[t]:tstart[t] + counts[t]]
        if counts[t]:
            ox, oy = (toff[t] % GRID_X) * 16, (toff[t] // GRID_X) * 16
            band, wide = [1e-4, 0.0, 0.5, 0.5], [1e-4, 0.0, 1e-4, 0.3]
            pay = [0.5] * C
            run = np.concatenate([np.float32([[ox + 7.5, oy + 3.5, *band, *pay],
                                              [ox + 7.5, oy + 7.5, *wide, *pay],
                                              [ox + 7.5, oy + 12.5, *band, *pay]]), run])
            new_counts[t] += 3
        runs.append(run)
    rows = np.concatenate(runs).astype(np.float32)
    tstart = (np.cumsum(new_counts) - new_counts).astype(np.int32)
    out = with_cotangents(rows, new_counts, tstart, toff, seed)
    out[6][:, 0, :] = -0.0
    return out


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


def dense_starts(stream, tile_offset=0):
    """The stream positions of a dense block's tiles (make_dense's and
    dense_of's layout): tile d of the block is the run of the stream tile
    whose pixels are those of image tile d + tile_offset. -> tstart [T]
    int32, T the tiles kept."""
    tstart, toff = stream[2], stream[3]
    keep = toff >= tile_offset
    out = np.zeros(int(keep.sum()), np.int32)
    out[toff[keep] - tile_offset] = tstart[keep]
    return out


def to_dense_tiles(x, toff, tile_offset=0):
    """Per-tile rows of a stream (accum, t_final or their cotangents, [T, ...])
    in the order of its dense block's tiles."""
    keep = torch.nonzero(toff >= tile_offset).squeeze(1)
    out = torch.zeros((keep.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[toff[keep].long() - tile_offset] = x[keep]
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 4, 7, 16])
def test_kernel_matches_plain(cuda, C):
    args = [torch.as_tensor(x, device=cuda) for x in make_stream(C=C)]
    before = blend_stream_fwd.launches
    acc, t_final = blend_stream_fwd(*args, GRID_X, CHUNK)
    torch.cuda.synchronize()
    assert blend_stream_fwd.launches == before + 1
    acc_p, t_p = blend_stream_fwd_plain(*args, GRID_X, CHUNK)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)  # bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7])
def test_bwd_kernel_matches_plain(cuda, C):
    args = [torch.as_tensor(x, device=cuda) for x in make_bwd_stream(C=C)]
    before = blend_stream_bwd.launches
    d = blend_stream_bwd(*args, GRID_X, CHUNK)
    torch.cuda.synchronize()
    assert blend_stream_bwd.launches == before + 1
    assert torch.equal(d, blend_stream_bwd_plain(*args, GRID_X, CHUNK))  # bit for bit


def dense_of(stream, chunk=CHUNK, tile_offset=0):
    """A stream's tile runs as a dense block: row toff[t] - tile_offset of
    the block is the run of stream tile t (for toff[t] >= tile_offset), K
    the deepest run rounded up to chunk. -> (gdata [T, K, F], counts [T])."""
    rows, counts, tstart, toff = stream[:4]
    K = -(-int(counts.max()) // chunk) * chunk
    T = int((toff >= tile_offset).sum())
    gdata = np.zeros((T, K, rows.shape[1]), np.float32)
    dcounts = np.zeros(T, np.int32)
    for t in np.flatnonzero(toff >= tile_offset):
        d = toff[t] - tile_offset
        gdata[d, :counts[t]] = rows[tstart[t]:tstart[t] + counts[t]]
        dcounts[d] = counts[t]
    return gdata, dcounts


def check_fwd_kernels_bitwise(stream, dev, chunk=CHUNK):
    """K1 on the stream and K5 on its dense block against their plain
    versions, bit for bit, each through one launch of its kernel.
    -> K1's plain (accum, t_final)."""
    args = [torch.as_tensor(x, device=dev) for x in stream[:4]]
    before = blend_stream_fwd.launches
    out = blend_stream_fwd(*args, GRID_X, chunk)
    torch.cuda.synchronize()
    assert blend_stream_fwd.launches == before + 1
    want = blend_stream_fwd_plain(*args, GRID_X, chunk)
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    gdata, dcounts = (torch.as_tensor(x, device=dev) for x in dense_of(stream, chunk))
    before = blend_tiles_fwd.launches
    out = blend_tiles_fwd(gdata, dcounts, GRID_X, chunk)
    torch.cuda.synchronize()
    assert blend_tiles_fwd.launches == before + 1
    assert all(torch.equal(x, y) for x, y in
               zip(out, blend_tiles_fwd_plain(gdata, dcounts, GRID_X, chunk)))
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("make", [make_deep_bwd_stream, make_flat_bwd_stream])
@pytest.mark.parametrize("C", [1, 4, 7, 16])
def test_fwd_kernels_bit_equal_on_deep_and_opaque_runs(cuda, make, C):
    """K1 and K5 bit for bit at C = 1, 4, 7 and 16 (each channel bucket) on
    a run of over ten chunks, most of whose pixels stay live to its end, and
    on flat opaque splats, where every tile stops after its first chunk
    while its second is in flight."""
    stream = make(C=C)
    acc, t_final = check_fwd_kernels_bitwise(stream, cuda)
    rows, counts, tstart, toff = stream[:4]
    assert acc.abs().max() > 0 and counts.max() > CHUNK
    if make is make_deep_bwd_stream:  # the deep run's last chunk changes its pixels
        cut = counts.copy()
        cut[2] = 10 * CHUNK
        args = [torch.as_tensor(x, device=cuda) for x in (rows, cut, tstart, toff)]
        assert not torch.equal(blend_stream_fwd_plain(*args, GRID_X, CHUNK)[1][2], t_final[2])
    else:  # every pixel of a tile of 3 slots or more stops at its third
        assert (t_final[torch.as_tensor(counts >= 3, device=cuda)] < 1e-3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 16])
def test_fwd_kernels_bit_equal_at_a_chunk_of_512(cuda, C):
    """K1 and K5 bit for bit at a chunk of 512 slots, more than the CTA's
    256 threads, so each thread computes two slots' cull boxes; at C = 16
    the two staging buffers pass 48 KiB of shared memory."""
    stream = make_deep_bwd_stream(C=C)
    assert stream[1].max() > 256
    check_fwd_kernels_bitwise(stream, cuda, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7])
def test_stream_fwd_kernel_bit_equal_off_16_byte_boundaries(cuda, C):
    """K1 bit for bit where the tiles' runs start off a 16-byte boundary:
    the stream's rows begin 4 (6 + C + 1) bytes into a buffer, as a view,
    so every run starts wherever its tstart puts it."""
    rows, counts, tstart, toff = make_deep_bwd_stream(C=C)[:4]
    P, F = rows.shape
    flat = torch.as_tensor(np.concatenate([np.zeros(F + 1, np.float32), rows.ravel()]),
                           device=cuda)
    r = flat[F + 1:].view(P, F)
    starts = {(r.data_ptr() + int(s) * F * 4) % 16 for s, n in zip(tstart, counts) if n}
    assert len(starts) > 1 and starts != {0}
    args = [r] + [torch.as_tensor(x, device=cuda) for x in (counts, tstart, toff)]
    acc, t_final = blend_stream_fwd(*args, GRID_X, CHUNK)
    torch.cuda.synchronize()
    acc_p, t_p = blend_stream_fwd_plain(*args, GRID_X, CHUNK)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,aligned", [(10, True), (CHUNK, False)])
def test_dense_fwd_kernel_bit_equal_off_the_bulk_copy(cuda, chunk, aligned):
    """K5 bit for bit where its chunks cannot arrive by bulk copy, both with
    a tile_offset: a chunk that is not a multiple of 4, and a block 4 bytes
    off a 16-byte boundary. The kernel stages them element-wise itself; the
    wrapper launches it all the same."""
    gdata, counts, _ = make_dense(C=7, tile_offset=4)
    T, Kd, F = gdata.shape
    flat = torch.as_tensor(np.concatenate([np.zeros(1, np.float32), gdata.ravel()]),
                           device=cuda)
    g = flat[1:].clone().view(T, Kd, F) if aligned else flat[1:].view(T, Kd, F)
    assert (g.data_ptr() % 16 == 0) == aligned
    c = torch.as_tensor(counts, device=cuda)
    before = blend_tiles_fwd.launches
    acc, t_final = blend_tiles_fwd(g, c, GRID_X, chunk, 4)
    torch.cuda.synchronize()
    assert blend_tiles_fwd.launches == before + 1
    acc_p, t_p = blend_tiles_fwd_plain(g, c, GRID_X, chunk, 4)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)


def check_bwd_kernels_bitwise(stream, dev, chunk=CHUNK):
    """K2, K4 and K6 on the stream (K6 on its dense block, with the stream's
    forward outputs and cotangents) against their plain versions, bit for
    bit (K4 on the tiles' range, its ids everywhere), and K6's rows against
    K2's. -> K2's plain rows."""
    args = [torch.as_tensor(x, device=dev) for x in stream]
    d = blend_stream_bwd(*args, GRID_X, chunk)
    torch.cuda.synchronize()
    d_p = blend_stream_bwd_plain(*args, GRID_X, chunk)
    assert torch.equal(d, d_p)
    n = 57
    gauss = torch.as_tensor(np.random.default_rng(1).integers(0, n, stream[0].shape[0]),
                            dtype=torch.int32, device=dev)
    cargs = (*args[:4], gauss, *args[4:], GRID_X, chunk, n)
    d4, ids = blend_stream_bwd_compact(*cargs)
    torch.cuda.synchronize()
    d4_p, ids_p = blend_stream_bwd_compact_plain(*cargs)
    live = compact_offsets(args[1], chunk)[1] * chunk
    assert torch.equal(d4[:live], d4_p[:live]) and torch.equal(ids, ids_p)
    gdata, dcounts = (torch.as_tensor(x, device=dev) for x in dense_of(stream, chunk))
    bargs = (gdata, dcounts, torch.as_tensor(dense_starts(stream), device=dev),
             stream[0].shape[0], *(to_dense_tiles(x, args[3]) for x in args[4:]),
             GRID_X, chunk)
    d6 = blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(d6, blend_tiles_bwd_plain(*bargs))
    assert torch.equal(d6, d)  # the stream backward's rows, at the same places
    return d_p


@pytest.mark.gpu
@pytest.mark.parametrize("make", [make_deep_bwd_stream, make_flat_bwd_stream,
                                  make_zero_sign_bwd_stream])
@pytest.mark.parametrize("C", [1, 4, 7, 10, 16])
def test_bwd_kernels_bit_equal_on_deep_and_opaque_runs(cuda, make, C):
    """K2, K4 and K6 against their plain versions, bit for bit, at C = 1, 4,
    7, 10 and 16 (each channel bucket of the walk), on a run of over ten chunks,
    most of whose pixels stay live to its end, and on flat opaque splats,
    where every tile stops after its first chunk while its second is in
    flight and the rest of each run gets no row, and on runs where some
    warps sum a slot's field to -0 while the others skip it."""
    stream = make(C=C)
    d_p = check_bwd_kernels_bitwise(stream, cuda)
    rows, counts, tstart = stream[:3]
    if make is make_deep_bwd_stream:  # the last chunk of the deep run has rows
        assert counts[2] > 10 * CHUNK and d_p[int(tstart[2]) + 10 * CHUNK:].abs().sum() > 0
    elif make is make_zero_sign_bwd_stream:  # a field summed from -0 terms only
        assert d_p.abs().sum() > 0 and not d_p[:, 6].any()
    else:  # rows past the first chunk of each tile stay zero
        assert d_p.abs().sum() > 0 and counts.max() > CHUNK
        for t in range(len(counts)):
            assert not d_p[int(tstart[t]) + CHUNK:int(tstart[t] + counts[t])].any()


@pytest.mark.gpu
@pytest.mark.parametrize("C,chunk", [(12, CHUNK), (16, CHUNK), (4, 512)])
def test_bwd_kernels_bit_equal_wide_rows_and_long_chunks(cuda, C, chunk):
    """K2, K4 and K6 bit for bit on the deep run at 18 and 22 fields (the
    walk that holds 32 values per lane) and at a chunk of 512 slots, more
    than the CTA's 256 threads, so each thread computes two slots' boxes
    (K6's chunks by bulk copy)."""
    stream = make_deep_bwd_stream(C=C)
    assert stream[1].max() > 256
    d_p = check_bwd_kernels_bitwise(stream, cuda, chunk)
    assert d_p[int(stream[2][2]) + 256:].abs().sum() > 0  # rows past slot 256 of the run


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7])
def test_compact_bwd_kernel_matches_plain(cuda, C):
    """K4 against its plain version (rows on the tiles' range, ids
    everywhere: n on every row past it), and K4 + K3 against K2 + K3 per
    splat, with K4 and K3 under torch.cuda.set_sync_debug_mode("error"), so
    a host sync on their path fails. The buffers come from torch.empty, and
    NaN-filled blocks of their sizes wait in the caching allocator, so a row
    or an id the kernel failed to write would show."""
    stream = make_bwd_stream(C=C)
    args = [torch.as_tensor(x, device=cuda) for x in stream]
    n = 57
    P = stream[0].shape[0]
    gauss = torch.as_tensor(np.random.default_rng(0).integers(0, n, P),
                            dtype=torch.int32, device=cuda)
    R = compact_rows(P, len(stream[1]), CHUNK)
    live = compact_offsets(args[1], CHUNK)[1] * CHUNK
    assert R > live
    poison = [torch.full((R, C + 6), float("nan"), device=cuda),
              torch.full((R,), float("nan"), device=cuda)]
    del poison
    before = blend_stream_bwd_compact.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, ids = blend_stream_bwd_compact(*args[:4], gauss, *args[4:], GRID_X, CHUNK, n)
        per = segment_reduce(d, ids, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert blend_stream_bwd_compact.launches == before + 1
    assert d.shape == (R, C + 6) and ids.shape == (R,)
    d_p, ids_p = blend_stream_bwd_compact_plain(*args[:4], gauss, *args[4:], GRID_X, CHUNK, n)
    assert torch.equal(d[:live], d_p[:live])  # bit for bit
    assert torch.equal(ids, ids_p) and bool((ids[live:] == n).all())
    per2 = segment_reduce(blend_stream_bwd(*args, GRID_X, CHUNK), gauss, n)
    torch.testing.assert_close(per, per2, atol=1e-5 * float(per2.abs().max()), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("F,aligned", [(10, True), (13, True), (10, False)])
def test_reduce_kernel_matches_plain(cuda, F, aligned):
    """K3 for the stream's F = 10 (vector atomics) and the dense block's
    F = 13 (scalar), and F = 10 rows 4 bytes off an 8-byte boundary (scalar):
    ids below 0 and at or past n dropped, all-zero rows and zero pairs
    skipped, over an output left NaN by the allocator."""
    rng = np.random.default_rng(5)
    R, n = 50_000, 3000
    x = rng.normal(0, 1, (R, F)).astype(np.float32)
    x[rng.uniform(size=R) < 0.6] = 0.0  # most rows all zero, as in the stream
    x[:, 1::3][rng.uniform(size=x[:, 1::3].shape) < 0.3] = 0.0
    flat = torch.as_tensor(np.concatenate([np.zeros(1, np.float32), x.ravel()]), device=cuda)
    rows = flat[1:].view(R, F) if not aligned else flat[1:].clone().view(R, F)
    assert (rows.data_ptr() % 8 == 0) == aligned
    ids_np = rng.integers(-5, n + 5, R).astype(np.int32)
    ids_np[:4] = [-(2**31), 2**31 - 1, n, -1]
    ids = torch.as_tensor(ids_np, device=cuda)
    poison = torch.full((n, F), float("nan"), device=cuda)
    del poison
    before = segment_reduce.launches
    out = segment_reduce(rows, ids, n)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    torch.testing.assert_close(out, segment_reduce_plain(rows, ids, n),
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
    gdata, counts, stream = make_dense(C=C, tile_offset=tile_offset)
    gdata[:, :5, 5] = 1.0  # alpha clamps at 0.99 near these splats' centers
    g, c = torch.as_tensor(gdata, device=cuda), torch.as_tensor(counts, device=cuda)
    before = (blend_tiles_fwd.launches, blend_tiles_bwd.launches)
    acc, t_final = blend_tiles_fwd(g, c, GRID_X, CHUNK, tile_offset)
    torch.cuda.synchronize()
    acc_p, t_p = blend_tiles_fwd_plain(g, c, GRID_X, CHUNK, tile_offset)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)  # bit for bit
    rng = np.random.default_rng(3)
    g_acc = torch.as_tensor(rng.normal(0, 0.1, acc.shape).astype(np.float32), device=cuda)
    g_t = torch.as_tensor(rng.normal(0, 0.1, t_final.shape).astype(np.float32), device=cuda)
    rows, s_counts, tstart, toff = stream
    args = (g, c, torch.as_tensor(dense_starts(stream, tile_offset), device=cuda),
            rows.shape[0], acc_p, t_p, g_acc, g_t, GRID_X, CHUNK, tile_offset)
    d = blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    assert (blend_tiles_fwd.launches, blend_tiles_bwd.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    assert d.shape == rows.shape
    assert torch.equal(d, blend_tiles_bwd_plain(*args))  # bit for bit
    # only the live rows of the block's tiles are written, at their stream places
    live = np.zeros(rows.shape[0], bool)
    for t in np.flatnonzero(toff >= tile_offset):
        live[tstart[t]:tstart[t] + s_counts[t]] = True
    assert not d[torch.as_tensor(~live, device=cuda)].any() and d.abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("chunk,aligned", [(10, True), (CHUNK, False), (512, True)])
def test_dense_bwd_kernel_bit_equal_on_and_off_the_bulk_copy(cuda, chunk, aligned):
    """K6 bit for bit, with a tile_offset, on the deep run's dense block: at a
    chunk of 10 (not a multiple of 4) and on a block 4 bytes off a 16-byte
    boundary, whose chunks cannot arrive by bulk copy, so the kernel stages
    them element-wise itself, and at a chunk of 512 by bulk copy, more slots
    than the CTA's threads. Its rows are K2's on the same tiles."""
    stream = make_deep_bwd_stream(C=4)
    args = [torch.as_tensor(x, device=cuda) for x in stream]
    toff = args[3]
    gdata, counts = dense_of(stream, chunk, tile_offset=4)
    T, Kd, F = gdata.shape
    assert counts.max() > 10 * CHUNK  # the deep run is one of the block's tiles
    flat = torch.as_tensor(np.concatenate([np.zeros(1, np.float32), gdata.ravel()]),
                           device=cuda)
    g = flat[1:].clone().view(T, Kd, F) if aligned else flat[1:].view(T, Kd, F)
    assert (g.data_ptr() % 16 == 0) == aligned
    bargs = (g, torch.as_tensor(counts, device=cuda),
             torch.as_tensor(dense_starts(stream, 4), device=cuda), stream[0].shape[0],
             *(to_dense_tiles(x, toff, 4) for x in args[4:]), GRID_X, chunk, 4)
    before = blend_tiles_bwd.launches
    d = blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    assert blend_tiles_bwd.launches == before + 1
    assert torch.equal(d, blend_tiles_bwd_plain(*bargs))
    kept = torch.where(toff >= 4, args[1], 0)  # K2 on the block's tiles alone
    assert torch.equal(d, blend_stream_bwd(args[0], kept, *args[2:], GRID_X, chunk))


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


def normalised_err(got, want) -> float:
    return float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("payload_rgb", [True, False])
def test_render_selection_on_card_matches_cpu(cuda, payload_rgb):
    """The selection render of the text and click queries (one K1 launch)
    against the same on the CPU, with the leaf-level scale cull on."""
    import dataclasses

    from opengaussian_tpu_torch.models.gaussians import create_from_pcd
    from opengaussian_tpu_torch.render import render_selection

    rng = np.random.default_rng(5)
    n = 400
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.permutation(np.linspace(2.5, 5.0, n))], -1).astype(np.float32)
    st = create_from_pcd(pts, rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                         capacity=512, device="cpu")
    st = dataclasses.replace(
        st, log_scales=torch.log(torch.as_tensor(rng.uniform(0.03, 0.16, (512, 3)),
                                                 dtype=torch.float32)),
        logit_opacity=torch.where(st.alive, 2.0, -10.0),
        ins_feat=torch.as_tensor(rng.normal(size=(512, 6)), dtype=torch.float32))
    st_g = dataclasses.replace(st, **{f.name: getattr(st, f.name).to(cuda)
                                      for f in dataclasses.fields(st)})
    select = torch.as_tensor(rng.random(512) < 0.6)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 80)
    before = blend_stream_fwd.launches
    got = render_selection(cam, st_g, torch.ones(3, device=cuda), select.to(cuda),
                           payload_rgb=payload_rgb)
    torch.cuda.synchronize()
    assert blend_stream_fwd.launches == before + 1
    want = render_selection(cam, st, torch.ones(3), select, payload_rgb=payload_rgb)
    assert got.cluster_imgs.is_cuda
    for k in ("cluster_imgs", "cluster_silhouettes"):
        assert normalised_err(getattr(got, k), getattr(want, k)) <= 1e-3, k
    assert bool(got.cluster_valid) == bool(want.cluster_valid)
    assert bool(got.cluster_occur) == bool(want.cluster_occur)


@pytest.mark.gpu
def test_lpips_on_card_matches_cpu(cuda):
    """LPIPS on the card with cuDNN's TF32 at torch's default (allowed): the
    call pins float32 itself, so it agrees with the CPU."""
    from opengaussian_tpu_torch.eval.lpips import LPIPS, random_weights

    w = random_weights(seed=3)
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (80, 96, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = LPIPS(w, cuda)(a, b)
        assert torch.backends.cudnn.allow_tf32  # restored after the call
    finally:
        torch.backends.cudnn.allow_tf32 = old
    want = LPIPS(w, "cpu")(a, b)
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["stream", "dense"])
def test_refiner_on_card_matches_cpu(cuda, layout):
    """chip_smoke.py's check of the SAM refiner on the card against the CPU
    (two blobs, tests/test_refiner.py's scene): votes and weights to a
    normalised 1e-5, refined masks equal, one depth render per view through
    the layout's forward kernel. TF32 is allowed around it: the refiner pins
    float32 for its products and gives the caller's setting back."""
    from chip_smoke import check_refiner_against_cpu

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        errs = check_refiner_against_cpu(cuda, layout)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert max(errs.values()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("C,G", [(4, 1), (7, 3), (7, 5)])
def test_group_entries_match_plain(cuda, C, G):
    """The group entries of K5 and K6 (a [G, N] opacity table read by splat
    id, the group a grid axis) against their plain versions, bit for bit,
    one launch each."""
    from opengaussian_tpu_torch.ops.rasterize_kernels import (
        blend_tiles_bwd_groups,
        blend_tiles_bwd_groups_plain,
        blend_tiles_fwd_groups,
        blend_tiles_fwd_groups_plain,
    )

    gdata, counts, stream = make_dense(seed=3, C=C)
    T, Kd, F = gdata.shape
    rng = np.random.default_rng(G)
    n = 97
    gauss_idx = rng.integers(0, n, size=(T, Kd)).astype(np.int32)
    opac_g = np.where(rng.uniform(size=(G, n)) < 0.3, 0.0,
                      rng.uniform(0.05, 0.99, size=(G, n))).astype(np.float32)
    opac_g[:, :5] = 1.0  # alpha clamps at 0.99 near these splats' centers
    g, c, gi, og = (torch.as_tensor(x, device=cuda) for x in (gdata, counts, gauss_idx, opac_g))
    before = (blend_tiles_fwd_groups.launches, blend_tiles_bwd_groups.launches)
    acc, tf = blend_tiles_fwd_groups(g, gi, og, c, GRID_X, CHUNK)
    cot = [torch.as_tensor(rng.normal(0, 0.1, x.shape).astype(np.float32), device=cuda)
           for x in (acc, tf)]
    ts = torch.as_tensor(dense_starts(stream), device=cuda)
    P = stream[0].shape[0]
    d = blend_tiles_bwd_groups(g, gi, og, c, ts, P, acc, tf, *cot, GRID_X, CHUNK)
    torch.cuda.synchronize()
    assert (blend_tiles_fwd_groups.launches, blend_tiles_bwd_groups.launches) == (
        before[0] + 1, before[1] + 1)
    acc_p, tf_p = blend_tiles_fwd_groups_plain(g, gi, og, c, GRID_X, CHUNK)
    assert torch.equal(acc, acc_p) and torch.equal(tf, tf_p)
    d_p = blend_tiles_bwd_groups_plain(g, gi, og, c, ts, P, acc, tf, *cot, GRID_X, CHUNK)
    assert torch.equal(d, d_p) and float(d_p.abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["stream", "dense", "compact"])
def test_fixed_budget_steps_sync_free_and_captured(cuda, layout, tmp_path):
    """chip_smoke.py's checks on the 160x120 blob trainer at fixed budgets:
    each stage's eager step runs under torch.cuda.set_sync_debug_mode
    ("error"), and its step captured as the trainer's blocks capture it (a
    CUDA graph over static buffers) equals the eager step to K3's tolerance;
    the stage-2.2 step of root 1 has ok true and a nonzero loss."""
    from chip_smoke import LAYOUTS, STAGES, blob_trainer, check_captured_step, \
        check_sync_free_step

    tr = blob_trainer(cuda, RasterizeConfig(**LAYOUTS[layout]), str(tmp_path))
    for stage in STAGES:
        check_sync_free_step(tr, stage)
        r = check_captured_step(tr, stage)
        assert r["err"] <= 1e-5, stage
    assert r["ok"] and r["loss"] > 0


@pytest.mark.gpu
def test_blocks_on_the_card(cuda, tmp_path):
    """Five stage-2.2 steps of the blob trainer as one captured block: the
    replays add the captured launches to the counters, the losses are
    finite, and a second block replays the same graph."""
    from chip_smoke import blob_trainer
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    tr = blob_trainer(cuda, RasterizeConfig(), str(tmp_path))
    tr.BLOCK_SIZES = (5,)
    tr.iteration = 62
    before = {w: w.launches for w in rk.KERNEL_WRAPPERS}
    tr.train(until=67, log_every=200)
    graph = tr._captured["2.2"].graph
    tr.train(until=72, log_every=200)
    torch.cuda.synchronize()
    assert tr._captured["2.2"].graph is graph
    assert rk.segment_reduce.launches - before[rk.segment_reduce] == 10
    assert rk.blend_stream_fwd.launches - before[rk.blend_stream_fwd] == 10
    assert len(tr.losses) == 10 and all(np.isfinite(float(x)) for x in tr.losses)


def make_windowed_stream(C=4):
    """tests/test_windows.py's deep scene at 64x48 (12 tiles), binned
    under tile windows (K 64, up to 12 windows a tile, window_extra 64, more
    than its deep tiles need) by the render path's own _prepare. -> (rows
    [P + CHUNK, 6 + C] whose last CHUNK rows are NaN, counts, tstart, toff
    [Tv] (each window's real tile), ids [P + CHUNK] (n past P), grid_x, n,
    P). The dead windows (count 0) start at P, on the NaN rows, so a kernel
    that read them would blend NaN."""
    from opengaussian_tpu_torch.ops.rasterize import _prepare, gather_rows

    rng = np.random.default_rng(2)
    n = 300
    means = np.stack([rng.normal(0, 0.08, n), rng.normal(0, 0.06, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.05, 0.6, n).astype(np.float32)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48)
    cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    cfg = RasterizeConfig(max_per_tile=64, chunk=CHUNK, tile_windows=12, window_extra=64)
    proj, bins, (gx, _) = _prepare(cam, torch.as_tensor(means), cov, torch.as_tensor(op), cfg)
    pay = torch.as_tensor(np.random.default_rng(1).uniform(size=(n, C)).astype(np.float32))
    opac = torch.where(proj.valid, torch.as_tensor(op), 0.0)
    rows = gather_rows(proj.mean2d, proj.conic, opac, pay, bins.sorted_gauss)
    P = rows.shape[0]
    dead = torch.arange(bins.counts.shape[0]) >= int(bins.vt_n.sum())
    assert int(bins.vt_n.max()) > 1 and bool(dead.any())
    assert not bool(bins.counts[dead].any()) and bool((bins.tile_start[dead] == P).all())
    rows = torch.cat([rows, torch.full((CHUNK, rows.shape[1]), float("nan"))])
    ids = torch.cat([bins.sorted_gauss, torch.full((CHUNK,), n, dtype=torch.int32)])
    return rows, bins.counts, bins.tile_start, bins.vt_real, ids, gx, n, P


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 7])
def test_kernels_bit_equal_on_a_windowed_stream(cuda, C):
    """K1, K2 and K4 on the virtual tiles of tile windows, dead windows
    included, against their plain versions bit for bit (which read no row
    past P): the windows' starts and counts need no window logic in the
    kernels, and a dead window reads nothing."""
    rows, counts, tstart, toff, ids, gx, n, P = make_windowed_stream(C)
    rows, counts, tstart, toff, ids = (x.to(cuda) for x in (rows, counts, tstart, toff, ids))
    live = rows[:P]
    acc, t_final = blend_stream_fwd(rows, counts, tstart, toff, gx, CHUNK)
    acc_p, t_p = blend_stream_fwd_plain(live, counts, tstart, toff, gx, CHUNK)
    assert torch.equal(acc, acc_p) and torch.equal(t_final, t_p)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cot = (torch.randn(acc.shape, generator=gen, device=cuda),
           torch.randn(t_final.shape, generator=gen, device=cuda))
    d = blend_stream_bwd(rows, counts, tstart, toff, acc, t_final, *cot, gx, CHUNK)
    d_p = blend_stream_bwd_plain(live, counts, tstart, toff, acc, t_final, *cot, gx, CHUNK)
    assert torch.equal(d[:P], d_p) and not bool(d[P:].any())
    d4, ids4 = blend_stream_bwd_compact(rows, counts, tstart, toff, ids, acc, t_final, *cot, gx,
                                        CHUNK, n)
    d4_p, ids4_p = blend_stream_bwd_compact_plain(live, counts, tstart, toff, ids[:P], acc,
                                                  t_final, *cot, gx, CHUNK, n)
    nc = compact_offsets(counts, CHUNK)[1] * CHUNK
    assert torch.equal(d4[:nc], d4_p[:nc]) and torch.equal(ids4[:nc], ids4_p[:nc])
    assert bool((ids4[nc:] == n).all())
