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


def depth_rank(depth: torch.Tensor) -> torch.Tensor:
    """Global depth rank (unique, stable): the sort key's minor part."""
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(depth.shape[0], device=depth.device)
    return rank


def bin_gaussians(
    proj: Projected, grid_x: int, grid_y: int, max_per_tile: int, dense: bool = False,
    rank: torch.Tensor | None = None, group_of: torch.Tensor | None = None,
    num_groups: int = 1, max_intersections: int = 0,
) -> TileBins:
    """Sort the frame's (splat, tile) slots by (tile, depth rank); with
    dense, also build the [T, max_per_tile] splat-index matrix.

    rank [N]: depth_rank(proj.depth), when the caller computed it already
    (group renders share one across their groups). group_of [N] int: each
    splat's group, 0..num_groups-1 (partition binning, stream only); splats
    in no group must have num_tiles 0. Counts and tile starts then span
    num_groups * T virtual tiles. max_intersections: the fixed slot budget P
    (0: sized per frame, with one host sync)."""
    if group_of is not None and dense:
        raise ValueError("partition binning is stream-only")
    num_tiles = grid_x * grid_y
    vt_total = num_tiles * num_groups
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
    edges = torch.searchsorted(
        tile_s, torch.arange(vt_total + 1, device=dev), side="left")
    tstart = edges[:-1]
    full_counts = edges[1:] - tstart
    counts = torch.clamp(full_counts, max=max_per_tile)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    gauss_idx = None
    if dense:  # slot k of tile t is stream slot tstart[t] + k while k < counts[t]
        k = torch.arange(max_per_tile, device=dev)
        pos = torch.clamp(tstart[:, None] + k[None, :], max=max(g_sorted.shape[0] - 1, 0))
        src = g_sorted if g_sorted.numel() else torch.zeros(1, dtype=g.dtype, device=dev)
        gauss_idx = i32(torch.where(k[None, :] < counts[:, None], src[pos], 0))
    total = nt.sum()
    n_dropped = (torch.clamp(total - P, min=0) if P > 0
                 else torch.zeros((), dtype=torch.int64, device=dev))
    return TileBins(
        counts=i32(counts),
        tile_start=i32(tstart),
        sorted_gauss=i32(g_sorted),
        total=i32(total),
        n_dropped=i32(n_dropped),
        n_truncated=i32((full_counts - counts).sum()),
        deepest=i32(full_counts.max()),
        gauss_idx=gauss_idx,
    )
