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

Unlike the JAX package, K never splits into tile windows (its Pallas stream
path's window branch of `tuned_config`): a CUDA kernel walks a tile's run
of any depth, so K simply grows to the deepest tile. The sharded probe and
the band budget of a device mesh are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig

PROBE_MULTIPLE = 10  # a generous pool, so that the probe itself drops nothing
PROBE_K = 2048  # the starting per-tile cap; doubled on saturation
HEADROOM = 1.3  # scenes evolve between probes (densification, optimization)
# the JAX package's cap on K before its stream path splits deep tiles into
# windows; the port keeps the constant for reference and never splits
WINDOW_K = 768


@torch.no_grad()
def _probe_view(means, cov3d, opac, camera, probe_p: int, probe_k: int):
    """-> (total intersections, deepest tile after the probe's cap) of one
    view, as 0-d tensors."""
    gx = (camera.width + TILE - 1) // TILE
    gy = (camera.height + TILE - 1) // TILE
    proj = project(means, cov3d, camera.to(means.device), opacities=opac)
    bins = bin_gaussians(proj, gx, gy, probe_k, max_intersections=probe_p)
    return bins.total, bins.counts.max()


def _sampled(cameras, max_views: int):
    step = max(1, len(cameras) // max_views)
    return cameras[::step][:max_views]


def _probe_escalating(probe_one, n: int) -> tuple[int, int]:
    """probe_one(probe_k) -> (total, count) at PROBE_K, doubled while the
    count reaches the cap (and the cap is below n)."""
    probe_k = PROBE_K
    while True:
        total, cnt = (int(x) for x in probe_one(probe_k))
        if cnt < probe_k or probe_k >= n:
            return total, cnt
        probe_k *= 2  # saturated: the measurement was clamped


def probe(state, cameras, max_views: int = 4) -> tuple[int, int]:
    """-> (largest intersection total, deepest tile) over up to max_views
    evenly spaced views, at the splats' alive opacities. A view whose
    deepest tile reaches the probe's cap is binned again at a doubled cap,
    so the counts are never the probe's own truncation."""
    cov3d = build_cov3d(state.scales, state.quats)
    opac = torch.where(state.alive, state.opacity, 0.0)
    n = state.capacity
    worst_total, worst_cnt = 0, 0
    for cam in _sampled(cameras, max_views):
        total, cnt = _probe_escalating(
            lambda k, cam=cam: _probe_view(state.means, cov3d, opac, cam,
                                           PROBE_MULTIPLE * n, k), n)
        worst_total = max(worst_total, total)
        worst_cnt = max(worst_cnt, cnt)
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
            t, c = _probe_view(state.means, cov3d, opac, cam, PROBE_MULTIPLE * n, k)
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
                 headroom: float = HEADROOM) -> RasterizeConfig:
    """Size the slot budget P and the per-tile cap K to the probed scene with
    `headroom`. The base config caps the result while the headroomed need
    fits under it; when it does not, the budgets grow past the base rather
    than truncate.

    headroom 1.3 suits training, where scenes evolve between probes; for a
    static scene the probe's maximum over the rendered views is exact and a
    tight fit (e.g. 1.05) is the right call."""
    total, cnt = probe(state, cameras, max_views)
    n = state.capacity
    ceiling = base.max_intersections(n)

    want_p = total * headroom if total else float(ceiling)
    p = min(max(_round_up(want_p, 65536), 2 * n), ceiling)
    if p < want_p:  # the base cap bites into the headroom margin: grow
        p = _round_up(want_p, 8192)

    want_k = cnt * headroom if cnt else float(base.max_per_tile)
    k = min(max(_round_up(want_k, base.chunk), 2 * base.chunk), base.max_per_tile)
    if k < want_k:
        k = _round_up(want_k, base.chunk)
    return dataclasses.replace(base, intersection_budget=p, max_per_tile=k)
