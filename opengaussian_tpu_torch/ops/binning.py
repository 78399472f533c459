"""Tile binning: splat -> (tile, depth)-sorted slot stream.

Port of opengaussian_tpu/ops/binning.py, stream and dense layouts. Each
splat is expanded into one slot per tile of its rect, slots that fail the
exact circle-tile cull are moved past the last tile, and one sort by (tile,
global depth rank) makes every tile's slots a contiguous front-to-back run of
the stream: `tile_start[t]` and `counts[t]` address it. The dense layout
also lays each run out as row t of a [T, K] splat-index matrix `gauss_idx`
(K = max_per_tile): its first counts[t] entries are the run, front to back,
and the rest hold 0, as the JAX package's scatter leaves them. Partition
binning (`group_of`, `num_groups` = G, stream layout) puts each slot in the
virtual tile group_of * T + tile, so G disjoint groups bin in one sort and
counts / tile_start span G * T virtual tiles.

The slot buffer has one of two sizes. With a fixed budget P
(`max_intersections` > 0, the JAX package's static intersection budget),
every splat expands into its rect's slots in splat order and the slots past
P are dropped and counted in `n_dropped`, as the JAX package drops them;
the stream is then [P] long whatever the frame, no step reads a count back
to the host, and the slots that are culled or dropped sort past the last
tile with splat id n, so the per-splat reduce skips them. With 0 (the
default) the buffer is sized from this frame's exact intersection total, as
the reference CUDA rasterizer sizes its key buffer per frame, so no slot is
dropped and the culled slots keep their splat ids; this costs one host sync
per frame. The per-tile cap `max_per_tile` and its `n_truncated` count are
applied exactly as the JAX package applies them, so both packages produce
the same stream whenever the JAX package drops nothing (and, at a fixed P,
also when it does).

Two options of the JAX package restrict or split the per-tile outputs:
  * a tile band (`tile_lo`, `tile_hi`, or `band_size` for the sharded
    render): counts, tile starts and the dense matrix cover only tiles
    [tile_lo, tile_hi), while the stream covers whatever the projection
    holds (the sharded render clips it to the band first,
    projection.clip_rect_rows); tiles past the real grid count 0;
  * tile windows (`window_depth` S > 0, stream layout): a tile deeper than K
    becomes up to S consecutive virtual tiles of at most K slots each, so
    counts and tile starts span Tv = band + extra virtual tiles, and
    `vt_real`, `vt_first` and `vt_n` map them back to the real tiles. The
    blend composites each window from a transmittance of 1, and
    rasterize._fold_windows composes them. Virtual tiles past the last live
    window are dead: count 0, start at the stream's end.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.ops.projection import TILE, Projected


@dataclasses.dataclass(frozen=True)
class TileBins:
    counts: torch.Tensor  # [T] int32 slots each tile blends (<= max_per_tile);
    # [G * T] under partition binning
    tile_start: torch.Tensor  # [T] int32 offset of each tile's run
    sorted_gauss: torch.Tensor  # [P] int32 splat index per sorted slot (n for
    # the slots past the last tile under a fixed budget)
    total: torch.Tensor  # [] int32 intersections (rect slots before the cull)
    n_dropped: torch.Tensor  # [] int32 slots lost to the fixed budget P (0
    # when P is sized per frame)
    n_truncated: torch.Tensor  # [] int32 slots lost to max_per_tile
    deepest: torch.Tensor  # [] int32 slots in the deepest tile, before the cap
    gauss_idx: torch.Tensor | None = None  # [T, K] int32 splat per dense slot
    # tile windows (window_depth > 0): counts and tile_start are then over Tv
    # virtual tiles
    vt_real: torch.Tensor | None = None  # [Tv] int32 real tile of each
    # virtual tile, relative to the band's first tile
    vt_first: torch.Tensor | None = None  # [band] int32 first virtual tile of
    # each real tile
    vt_n: torch.Tensor | None = None  # [band] int32 windows of each real tile


def depth_rank(depth: torch.Tensor) -> torch.Tensor:
    """Global depth rank (unique, stable): the sort key's minor part."""
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(depth.shape[0], device=depth.device)
    return rank


def bin_gaussians(
    proj: Projected, grid_x: int, grid_y: int, max_per_tile: int, dense: bool = False,
    rank: torch.Tensor | None = None, group_of: torch.Tensor | None = None,
    num_groups: int = 1, max_intersections: int = 0, tile_lo: int = 0,
    tile_hi: int | None = None, band_size: int | None = None, window_depth: int = 0,
    window_extra: int = 0,
) -> TileBins:
    """Sort the frame's (splat, tile) slots by (tile, depth rank); with
    dense, also build the [T, max_per_tile] splat-index matrix.

    rank [N]: depth_rank(proj.depth), when the caller computed it already
    (group renders share one across their groups). group_of [N] int: each
    splat's group, 0..num_groups-1 (partition binning, stream only); splats
    in no group must have num_tiles 0. Counts and tile starts then span
    num_groups * T virtual tiles. max_intersections: the fixed slot budget P
    (0: sized per frame, with one host sync).

    tile_lo / tile_hi: the band of tiles the per-tile outputs cover (default
    all); band_size: the same with tile_hi = tile_lo + band_size, where tiles
    past the real grid (a mesh's padding) count 0. window_depth S > 0
    (stream layout): tile windows of at most max_per_tile slots, up to S per
    tile, within Tv = band + (window_extra or max(P // max_per_tile, 1))
    virtual tiles, P the stream's length; slots past S windows and windows
    past Tv are counted in n_truncated."""
    if group_of is not None and dense:
        raise ValueError("partition binning is stream-only")
    if group_of is not None and (tile_lo or tile_hi is not None or band_size is not None):
        raise ValueError("partition binning does not compose with tile bands")
    if window_depth > 0 and dense:
        raise ValueError("tile windows are stream-only")
    num_tiles = grid_x * grid_y
    vt_total = num_tiles * num_groups
    if band_size is not None:
        tile_hi = tile_lo + band_size
    elif tile_hi is None:
        tile_hi = vt_total
    band = tile_hi - tile_lo
    dev = proj.depth.device
    nt = proj.num_tiles.to(torch.int64)
    n = nt.shape[0]

    # expand: slot p belongs to splat g[p]; a splat's slots are contiguous
    # and splat indices ascend, as in the JAX package's scatter+cummax
    ends = torch.cumsum(nt, 0)
    starts = ends - nt
    P = max_intersections
    if P > 0:  # slot p < total lies in the first splat whose end passes p
        slot = torch.arange(P, device=dev)
        live = slot < ends[-1] if n else torch.zeros(P, dtype=torch.bool, device=dev)
        g = torch.clamp(torch.searchsorted(ends, slot, right=True), max=max(n - 1, 0))
    else:
        g = torch.repeat_interleave(torch.arange(n, device=dev), nt)  # [total]
        slot, live = torch.arange(g.shape[0], device=dev), None
    r = slot - starts[g]
    rect_min = proj.rect_min.to(torch.int64)[g]
    w = torch.clamp(proj.rect_max[:, 0].to(torch.int64) - proj.rect_min[:, 0], min=1)[g]
    tx = rect_min[:, 0] + r % w
    ty = rect_min[:, 1] + r // w

    # exact circle-tile cull: beyond the cutoff radius alpha < 1/255, so a
    # tile whose nearest point is farther than it receives nothing
    mean2d = proj.mean2d.detach()
    cx = mean2d[g, 0]
    cy = mean2d[g, 1]
    txf = tx.to(torch.float32) * float(TILE)
    tyf = ty.to(torch.float32) * float(TILE)
    nx = torch.minimum(torch.maximum(cx, txf), txf + (TILE - 1.0))
    ny = torch.minimum(torch.maximum(cy, tyf), tyf + (TILE - 1.0))
    rad = proj.cull_radius[g]
    ddx = cx - nx
    ddy = cy - ny
    hits = ddx * ddx + ddy * ddy <= rad * rad
    tid = ty * grid_x + tx
    if group_of is not None:
        tid = tid + torch.clamp(group_of.to(torch.int64), 0, num_groups - 1)[g] * num_tiles
    tile_id = torch.where(hits if live is None else hits & live, tid, vt_total)

    # one int64 key: tile major, depth rank minor (unique for live slots)
    if rank is None:
        rank = depth_rank(proj.depth.detach())
    key = tile_id * (n + 1) + rank.to(torch.int64)[g]
    key_s, order = torch.sort(key, stable=True)
    g_sorted = g[order]
    tile_s = key_s // (n + 1)
    if live is not None:  # the slots past the last tile reach no reduce
        g_sorted = torch.where(tile_s < vt_total, g_sorted, n)
    # one (band + 1)-query searchsorted gives both edges of every band tile
    band_ids = tile_lo + torch.arange(band + 1, device=dev)
    edges = torch.searchsorted(tile_s, band_ids, side="left")
    tstart = edges[:-1]
    # a band reaching past the real grid must not pick up the run of culled
    # slots at tile id vt_total
    full_counts = torch.where(band_ids[:-1] < vt_total, edges[1:] - tstart, 0)
    counts = torch.clamp(full_counts, max=max_per_tile)
    n_truncated = (full_counts - counts).sum()
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    gauss_idx = None
    if dense:  # slot k of tile t is stream slot tstart[t] + k while k < counts[t]
        k = torch.arange(max_per_tile, device=dev)
        pos = torch.clamp(tstart[:, None] + k[None, :], max=max(g_sorted.shape[0] - 1, 0))
        src = g_sorted if g_sorted.numel() else torch.zeros(1, dtype=g.dtype, device=dev)
        gauss_idx = i32(torch.where(k[None, :] < counts[:, None], src[pos], 0))
    windows = {}
    if window_depth > 0:
        counts, tstart, n_truncated, windows = _windows(
            full_counts, tstart, window_depth, max_per_tile, window_extra,
            g_sorted.shape[0])
    total = nt.sum()
    n_dropped = (torch.clamp(total - P, min=0) if P > 0
                 else torch.zeros((), dtype=torch.int64, device=dev))
    return TileBins(
        counts=i32(counts),
        tile_start=i32(tstart),
        sorted_gauss=i32(g_sorted),
        total=i32(total),
        n_dropped=i32(n_dropped),
        n_truncated=i32(n_truncated),
        deepest=i32(full_counts.max()),
        gauss_idx=gauss_idx,
        **{k: i32(v) for k, v in windows.items()},
    )


def _windows(full_counts, tstart, S: int, K: int, window_extra: int, P: int):
    """Split each real tile's run into up to S windows of at most K slots,
    laid out as consecutive virtual tiles (the JAX package's window branch
    of bin_gaussians). full_counts, tstart [band]: the real tiles' runs; P:
    the stream's length. -> (counts [Tv], tstart [Tv], n_truncated,
    {vt_real, vt_first, vt_n})."""
    band = full_counts.shape[0]
    dev = full_counts.device
    nwin = torch.clamp((full_counts + K - 1) // K, 1, S)
    covered = torch.minimum(full_counts, nwin * K)
    Tv = band + (window_extra or max(P // K, 1))
    vt_first = torch.cumsum(nwin, 0) - nwin
    total_w = vt_first[-1] + nwin[-1]
    vslot = torch.arange(Tv, device=dev)
    # the real tile of a virtual one: the last whose first window is not past it
    vt_real = torch.clamp(torch.searchsorted(vt_first, vslot, right=True) - 1, min=0)
    w = vslot - vt_first[vt_real]
    live = (vslot < total_w) & (w < nwin[vt_real]) & (w >= 0)
    counts = torch.where(live, torch.clamp(full_counts[vt_real] - w * K, 0, K), 0)
    tstart = torch.where(live, tstart[vt_real] + w * K, P)
    # slots past S windows of a tile, and windows past Tv
    n_truncated = (full_counts - covered).sum() + (covered.sum() - counts.sum())
    return counts, tstart, n_truncated, dict(vt_real=vt_real, vt_first=vt_first, vt_n=nwin)
