"""Tile binning: splat -> (tile, depth)-sorted slot stream.

Port of opengaussian_tpu/ops/binning.py, stream and dense layouts. Each
splat is expanded into one slot per tile of its rect, slots that fail the
exact circle-tile cull are moved past the last tile, and one sort by (tile,
global depth rank) makes every tile's slots a contiguous front-to-back run of
the stream: `tile_start[t]` and `counts[t]` address it. The dense layout
also lays each run out as row t of a [T, K] splat-index matrix `gauss_idx`
(K = max_per_tile): its first counts[t] entries are the run, front to back,
and the rest hold 0, as the JAX package's scatter leaves them.

Unlike the JAX package, the slot buffer is sized from this frame's exact
intersection total (as the reference CUDA rasterizer sizes its key buffer
per frame), so no slot is ever dropped and `n_dropped` is always 0. The
per-tile cap `max_per_tile` and its `n_truncated` count are kept exactly as
the JAX package applies them, so both packages produce the same stream
whenever the JAX package drops nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.ops.projection import TILE, Projected


@dataclasses.dataclass(frozen=True)
class TileBins:
    counts: torch.Tensor  # [T] int32 slots each tile blends (<= max_per_tile)
    tile_start: torch.Tensor  # [T] int32 offset of each tile's run
    sorted_gauss: torch.Tensor  # [P] int32 splat index per sorted slot
    total: torch.Tensor  # [] int32 intersections (rect slots before the cull)
    n_dropped: torch.Tensor  # [] int32, always 0 (P is sized per frame)
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
) -> TileBins:
    """Sort the frame's (splat, tile) slots by (tile, depth rank); with
    dense, also build the [T, max_per_tile] splat-index matrix."""
    num_tiles = grid_x * grid_y
    dev = proj.depth.device
    nt = proj.num_tiles.to(torch.int64)
    n = nt.shape[0]

    # expand: slot p belongs to splat g[p]; a splat's slots are contiguous
    # and splat indices ascend, as in the JAX package's scatter+cummax
    g = torch.repeat_interleave(torch.arange(n, device=dev), nt)  # [P]
    starts = torch.cumsum(nt, 0) - nt
    r = torch.arange(g.shape[0], device=dev) - starts[g]
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
    tile_id = torch.where(hits, ty * grid_x + tx, num_tiles)

    # one int64 key: tile major, depth rank minor (unique for live slots)
    rank = depth_rank(proj.depth.detach())
    key = tile_id * (n + 1) + rank[g]
    key_s, order = torch.sort(key, stable=True)
    g_sorted = g[order]
    tile_s = key_s // (n + 1)
    edges = torch.searchsorted(
        tile_s, torch.arange(num_tiles + 1, device=dev), side="left")
    tstart = edges[:-1]
    full_counts = edges[1:] - tstart
    counts = torch.clamp(full_counts, max=max_per_tile)
    i32 = lambda x: x.to(torch.int32)  # noqa: E731
    gauss_idx = None
    if dense:  # slot k of tile t is stream slot tstart[t] + k while k < counts[t]
        k = torch.arange(max_per_tile, device=dev)
        pos = torch.clamp(tstart[:, None] + k[None, :], max=max(g_sorted.shape[0] - 1, 0))
        live = k[None, :] < counts[:, None]
        src = g_sorted if g_sorted.numel() else torch.zeros(1, dtype=g.dtype, device=dev)
        gauss_idx = i32(torch.where(live, src[pos], 0))
    return TileBins(
        counts=i32(counts),
        tile_start=i32(tstart),
        sorted_gauss=i32(g_sorted),
        total=i32(nt.sum()),
        n_dropped=torch.zeros((), dtype=torch.int32, device=dev),
        n_truncated=i32((full_counts - counts).sum()),
        deepest=i32(full_counts.max()),
        gauss_idx=gauss_idx,
    )
