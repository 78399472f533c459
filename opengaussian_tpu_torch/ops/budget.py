"""Rasterizer budget tuning (port of opengaussian_tpu/ops/budget.py).

A fixed slot budget P (`RasterizeConfig.intersection_budget`) and per-tile
cap K (`max_per_tile`) give every step the same shapes, so that no step reads
a count back to the host and a step can be captured as a CUDA graph. Both
cost per-slot work whatever the frame holds, so they are sized to the scene:
`probe` bins a few views under a generous budget and returns the largest
intersection total and the deepest tile; a probe whose deepest tile reaches
its own cap doubles the cap and bins again, so the numbers it returns were
never truncated by it. `tuned_config` sizes P and K from them with headroom:
under the base config while the headroomed need fits it, past it (finely
rounded) when the scene needs more, since a budget below the need would
silently drop or truncate slots. The trainer re-tunes after a capacity
growth and when a logged step lost slots.

`probe_groups` and `tuned_group_config` do the same for the group renders
of group_render "scan" (one root per group: each group's own binning).

K grows to the deepest tile by default: a CUDA kernel walks a tile's run of
any depth. The JAX package's stream path instead caps K at WINDOW_K and
splits deeper tiles into tile windows; the port takes that branch only when
the base config asks for windows (`tile_windows > 0`): then K is WINDOW_K,
the window count covers the headroomed deepest tile, and `window_extra`
comes from the probe's count of extra windows (`probe.last_window_extras`,
one entry per WINDOW_K_CANDIDATES; `windowed_variant` sizes a config at
another of them). Under a device mesh of more than one rank
(parallel/mesh.py) each rank probes its own splats, the ranks sum the
per-tile counts and the per-band slot totals (`_band_totals`), and
`tuned_config` also sizes `band_intersection_budget`, the slot budget of
one rank's band in the sharded render.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig

PROBE_MULTIPLE = 10  # a generous pool, so that the probe itself drops nothing
PROBE_K = 2048  # the starting per-tile cap; doubled on saturation
HEADROOM = 1.3  # scenes evolve between probes (densification, optimization)
# the cap on K of the window branch of tuned_config (a base config with
# tile_windows > 0): deeper tiles split into windows of WINDOW_K slots
WINDOW_K = 768
WINDOW_K_CANDIDATES = (768, 512, 384, 256, 128)  # probed in one pass, so that
# windowed_variant can size other window depths without probing again


def _band_totals(proj, row_lo: torch.Tensor, row_hi: torch.Tensor) -> torch.Tensor:
    """The slots each band of tile rows [row_lo[b], row_hi[b]) expands to
    before the cull: the sum over splats of rect width x rect rows inside
    the band. Culled slots still take places in the sorted stream, so this,
    not the hits, sizes a band's budget. -> [B] int64."""
    ry_min = proj.rect_min[:, 1].to(torch.int64)
    ry_max = proj.rect_max[:, 1].to(torch.int64)
    w = (proj.rect_max[:, 0] - proj.rect_min[:, 0]).to(torch.int64)
    ov = torch.clamp(torch.minimum(ry_max[None, :], row_hi[:, None])
                     - torch.maximum(ry_min[None, :], row_lo[:, None]), min=0)
    return torch.where(proj.num_tiles[None, :] > 0, ov * w[None, :], 0).sum(dim=1)


def _window_extra(counts: torch.Tensor) -> torch.Tensor:
    """The windows past one per tile at each window depth of
    WINDOW_K_CANDIDATES: sum over tiles of ceil(count / k) - 1."""
    c = counts.to(torch.int64)
    return torch.stack([torch.clamp((c + k - 1) // k - 1, min=0).sum()
                        for k in WINDOW_K_CANDIDATES])


def _band_rows(mesh, gx: int, gy: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile rows [lo, hi) each rank's band of the sharded render covers:
    rank r owns tiles [r tl, (r + 1) tl) of the frame padded to a multiple
    of the ranks."""
    nd = mesh.size
    tl = -(-(gx * gy) // nd)
    lo = [(i * tl) // gx for i in range(nd)]
    hi = [((i + 1) * tl - 1) // gx + 1 for i in range(nd)]
    return (torch.tensor(lo, device=mesh.device), torch.tensor(hi, device=mesh.device))


@torch.no_grad()
def _probe_view(means, cov3d, opac, camera, probe_p: int, probe_k: int, mesh=None):
    """-> (total intersections, deepest tile after the probe's cap, the
    largest band total, the extra windows [len(WINDOW_K_CANDIDATES)]) of one
    view, as tensors. With a mesh, means, cov3d and opac are this rank's
    splats: the ranks sum their totals, per-tile counts and band totals, so
    each splat counts once, on its owner rank."""
    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    proj = project(means, cov3d, camera.to(means.device), opacities=opac)
    bins = bin_gaussians(proj, gx, gy, probe_k, max_intersections=probe_p)
    total, counts = bins.total.to(torch.int64), bins.counts.to(torch.int64)
    bt = torch.zeros(1, dtype=torch.int64, device=means.device)
    if mesh is not None:
        bt = _band_totals(proj, *_band_rows(mesh, gx, gy))
        summed = torch.cat([total[None], counts, bt])
        dist.all_reduce(summed, group=mesh.group)
        total, counts, bt = summed[0], summed[1:1 + counts.shape[0]], summed[1 + counts.shape[0]:]
    return total, counts.max(), bt.max(), _window_extra(counts)


def _sampled(cameras, max_views: int):
    step = max(1, len(cameras) // max_views)
    return cameras[::step][:max_views]


def _probe_escalating(probe_one, n: int) -> tuple:
    """probe_one(probe_k) -> (total, count, ...) at PROBE_K, doubled while
    the count reaches the cap (and the cap is below n). -> (total, count)
    as ints, then the rest as probe_one gave it."""
    probe_k = PROBE_K
    while True:
        total, cnt, *rest = probe_one(probe_k)
        total, cnt = int(total), int(cnt)
        if cnt < probe_k or probe_k >= n:
            return (total, cnt, *rest)
        probe_k *= 2  # saturated: the measurement was clamped


def _global_capacity(state, mesh) -> int:
    return state.capacity * (mesh.size if mesh is not None else 1)


def probe(state, cameras, max_views: int = 4, mesh=None, band: bool = False):
    """-> (largest intersection total, deepest tile) over up to max_views
    evenly spaced views, at the splats' alive opacities; with band, also the
    largest slot total of one rank's band. A view whose deepest tile
    reaches the probe's cap is binned again at a doubled cap, so the counts
    are never the probe's own truncation. With a mesh, `state` is this
    rank's shard (parallel/mesh.py:shard_gaussians) and every rank gets the
    whole scene's numbers. The worst extra-window counts are left in
    `probe.last_window_extras`, by window depth, for tuned_config and
    windowed_variant."""
    cov3d = build_cov3d(state.scales, state.quats)
    opac = torch.where(state.alive, state.opacity, 0.0)
    n = _global_capacity(state, mesh)
    worst_total, worst_cnt, worst_band = 0, 0, 0
    worst_wx = np.zeros(len(WINDOW_K_CANDIDATES), np.int64)
    for cam in _sampled(cameras, max_views):
        total, cnt, bt, wx = _probe_escalating(
            lambda k, cam=cam: _probe_view(state.means, cov3d, opac, cam,
                                           PROBE_MULTIPLE * n, k, mesh), n)
        worst_total = max(worst_total, total)
        worst_cnt = max(worst_cnt, cnt)
        worst_band = max(worst_band, int(bt))
        worst_wx = np.maximum(worst_wx, wx.cpu().numpy())
    probe.last_window_extras = dict(zip(WINDOW_K_CANDIDATES, worst_wx.tolist()))
    if band:
        return worst_total, worst_cnt, worst_band
    return worst_total, worst_cnt


def _round_up(x: float, q: int) -> int:
    return int(math.ceil(x / q) * q)


def probe_groups(state, cameras, group_opac: torch.Tensor,
                 max_views: int = 4) -> tuple[int, int]:
    """-> (largest per-group intersection total, deepest per-group tile) over
    sampled views, each group binned alone with its masked opacities, as
    rasterize_scan_groups bins it. group_opac [G, N]: the groups' masked
    opacities (the per-root masks bound every group-render call site: leaves
    are subsets of their root). The same escalating cap as `probe`."""
    cov3d = build_cov3d(state.scales, state.quats)
    opac_g = torch.where(state.alive[None, :], group_opac, 0.0)
    n = state.capacity

    def one_view(cam, k):
        tot = cnt = torch.zeros((), dtype=torch.int32, device=state.means.device)
        for opac in opac_g:
            t, c, *_ = _probe_view(state.means, cov3d, opac, cam, PROBE_MULTIPLE * n, k)
            tot, cnt = torch.maximum(tot, t), torch.maximum(cnt, c)
        return tot, cnt

    worst_total, worst_cnt = 0, 0
    for cam in _sampled(cameras, max_views):
        total, cnt = _probe_escalating(lambda k, cam=cam: one_view(cam, k), n)
        worst_total = max(worst_total, total)
        worst_cnt = max(worst_cnt, cnt)
    return worst_total, worst_cnt


def tuned_group_config(base: RasterizeConfig, state, cameras, cluster_ids,
                       num_groups: int, max_views: int = 4,
                       headroom: float = HEADROOM) -> RasterizeConfig:
    """Size group_intersection_budget and group_max_per_tile from a per-root
    probe. cluster_ids [N]: the root assignment; each root keeps its members
    at full opacity, as render_clusters masks them (the superset of every
    group-render call site). The frame budgets are left as they are: call on
    top of tuned_config's result."""
    gids = torch.arange(num_groups, device=cluster_ids.device)
    member = cluster_ids[None, :] == gids[:, None]  # [G, N]
    opac_g = torch.where(member, state.opacity[None, :], 0.0)
    total, cnt = probe_groups(state, cameras, opac_g, max_views)

    p = _round_up(max(total * headroom, 1.0), 8192)
    k = _round_up(max(cnt * headroom, 2.0 * base.chunk), base.chunk)
    return dataclasses.replace(base, group_intersection_budget=p, group_max_per_tile=k)


def tuned_config(base: RasterizeConfig, state, cameras, max_views: int = 4,
                 headroom: float = HEADROOM, mesh=None) -> RasterizeConfig:
    """Size the slot budget P and the per-tile cap K to the probed scene with
    `headroom`. The base config caps the result while the headroomed need
    fits under it; when it does not, the budgets grow past the base rather
    than truncate.

    headroom 1.3 suits training, where scenes evolve between probes; for a
    static scene the probe's maximum over the rendered views is exact and a
    tight fit (e.g. 1.05) is the right call.

    With base.tile_windows > 0 (stream layout) and a K past WINDOW_K, K
    stays at WINDOW_K and the deeper tiles split into windows: tile_windows
    covers the headroomed deepest tile, window_extra the probe's extra
    windows with headroom. With a mesh of more than one rank (`state` this
    rank's shard), band_intersection_budget covers the largest band's
    slots with headroom, at most P."""
    use_band = mesh is not None and mesh.size > 1
    total, cnt, *band_need = probe(state, cameras, max_views, mesh=mesh, band=use_band)
    n = _global_capacity(state, mesh)
    ceiling = base.max_intersections(n)

    want_p = total * headroom if total else float(ceiling)
    p = min(max(_round_up(want_p, 65536), 2 * n), ceiling)
    if p < want_p:  # the base cap bites into the headroom margin: grow
        p = _round_up(want_p, 8192)

    want_k = cnt * headroom if cnt else float(base.max_per_tile)
    k = min(max(_round_up(want_k, base.chunk), 2 * base.chunk), base.max_per_tile)
    if k < want_k:
        k = _round_up(want_k, base.chunk)
    windows, window_extra = base.tile_windows, base.window_extra
    if base.pallas_input == "stream" and windows > 0 and k > WINDOW_K:
        windows = math.ceil(want_k / WINDOW_K)
        k = WINDOW_K
        wx = getattr(probe, "last_window_extras", {}).get(WINDOW_K, 0)
        window_extra = _round_up(max(wx, 1) * headroom, 64)
    band_p = 0
    if use_band:  # at most the frame's budget (a one-row image's band is the frame)
        band_p = min(_round_up(max(band_need[0] * headroom, 1.0), 8192), p)
    return dataclasses.replace(base, intersection_budget=p, max_per_tile=k,
                               tile_windows=windows, window_extra=window_extra,
                               band_intersection_budget=band_p)


def windowed_variant(cfg: RasterizeConfig, window_k: int,
                     headroom: float = HEADROOM) -> RasterizeConfig:
    """A tuned config at a shallower window depth K = window_k, with enough
    windows to cover the tuned depth and window_extra from the last probe's
    extra windows at that depth (`probe.last_window_extras`): call after
    tuned_config. The kernels stage a tile's run chunk by chunk whatever K
    is, so the trade is the fold's work against a shorter deepest walk."""
    depth = cfg.max_per_tile * max(cfg.tile_windows, 1)
    wx = getattr(probe, "last_window_extras", {}).get(window_k, 0)
    return dataclasses.replace(cfg, max_per_tile=window_k,
                               tile_windows=math.ceil(depth / window_k),
                               window_extra=_round_up(max(wx, 1) * headroom, 64))
