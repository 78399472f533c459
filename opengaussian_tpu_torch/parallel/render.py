"""The sharded render and stage-0 training step over a device mesh (port of
opengaussian_tpu/parallel/render.py).

One render, on every rank of the mesh (parallel/mesh.py):
  * each rank projects its own shard of the splats;
  * an all-gather of the projected table (`_gather_proj`) gives every rank
    the whole scene's splats; its backward is a reduce-scatter (sum) of the
    per-splat gradients to their owner ranks, because every rank's tiles
    read every splat;
  * each rank bins and blends only its band of tile rows: rank r owns tiles
    [r tl, (r + 1) tl) of the frame padded to a multiple of the ranks. With
    `band_intersection_budget` it clips the gathered table to those rows
    (projection.clip_rect_rows) and bins only their slots, tile windows
    allowed; else it bins the whole frame and keeps its tiles. K1 (stream)
    or K5 (dense) blend them with the band's tile offset; the backward is
    K2, K4 or K6 with K3 over the gathered N, as on one device;
  * an all-gather of the blended tiles gives every rank the whole image. Its
    backward keeps only this rank's slice of the incoming gradient: the loss
    is the same computation on every rank, so each rank's gradient of the
    image is already the whole one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import TileBins, bin_gaussians
from opengaussian_tpu_torch.ops.projection import Projected, clip_rect_rows, project
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    _blend,
    _blend_inputs,
    _grids,
    _untile,
)
from opengaussian_tpu_torch.parallel.mesh import Mesh
from opengaussian_tpu_torch.parallel.mesh import all_gather as _all_gather

# the collective under its newer name, where this torch has it
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _GatherRows(torch.autograd.Function):
    """[n, F] rows of every rank -> [D n, F]; the backward sums each rank's
    gradient of the whole and hands every rank its own rows' sum (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        out = g.new_empty((g.shape[0] // mesh.size, *g.shape[1:]))
        _REDUCE_SCATTER(out, g.contiguous(), group=mesh.group)
        return out, None


class _GatherTiles(torch.autograd.Function):
    """[tl, ...] tiles of every rank -> [D tl, ...]; the backward keeps this
    rank's slice of the gradient (every rank computed the same loss on the
    whole image, so no sum)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.rank * ctx.rows
        return g[r0:r0 + ctx.rows], None


def _gather_proj(mesh: Mesh, proj: Projected, payload, opac):
    """The projected table, payload and opacities of every rank's shard, in
    rank order -> (Projected [N], payload [N, C], opac [N]). The
    differentiable columns go through one all-gather with a reduce-scatter
    backward, the integer ones through one plain all-gather."""
    table = torch.cat([proj.mean2d, proj.conic, proj.depth[:, None], opac[:, None],
                       proj.cull_radius.detach()[:, None], payload], dim=-1)
    t = _GatherRows.apply(table, mesh)
    ints = torch.cat([proj.radius[:, None], proj.rect_min, proj.rect_max,
                      proj.num_tiles[:, None], proj.valid[:, None]], dim=-1).to(torch.int32)
    i = _all_gather(ints, mesh)
    return Projected(mean2d=t[:, 0:2], conic=t[:, 2:5], depth=t[:, 5],
                     cull_radius=t[:, 7].detach(), radius=i[:, 0], rect_min=i[:, 1:3],
                     rect_max=i[:, 3:5], num_tiles=i[:, 5], valid=i[:, 6].bool()), \
        t[:, 8:], t[:, 6]


def _rows(x: torch.Tensor, t0: int, tl: int, value=0) -> torch.Tensor:
    """Rows [t0, t0 + tl) of x, padded with `value` past its end (a rank's
    tiles of a [T, ...] tensor, the frame padded to a multiple of the
    ranks)."""
    pad = max(0, t0 + tl - x.shape[0])
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad), value=value)
    return x[t0:t0 + tl].contiguous()


def _tile_slice(bins: TileBins, t0: int, tl: int) -> TileBins:
    """A whole frame's bins cut to tiles [t0, t0 + tl) of the frame padded
    with empty tiles (count 0, start at the stream's end)."""
    return dataclasses.replace(
        bins, counts=_rows(bins.counts, t0, tl),
        tile_start=_rows(bins.tile_start, t0, tl, bins.sorted_gauss.shape[0]),
        gauss_idx=None if bins.gauss_idx is None else _rows(bins.gauss_idx, t0, tl))


def render_sharded(mesh: Mesh, camera: Camera, means3d, cov3d, opacities, payload, bg,
                   config: RasterizeConfig = RasterizeConfig(), screen_tap=None):
    """Render a payload [n, C] whose splats are sharded over the mesh (each
    rank passes its own n = N / D rows: parallel/mesh.py:shard_gaussians).
    -> (image [H, W, C], alpha [H, W], depth [H, W], the same on every rank;
    radii [n] of this rank's splats; n_lost, the slots dropped or truncated,
    summed over the bands when banded, else the whole frame's on every
    rank). screen_tap [n, 2]: this rank's densification tap."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"render_sharded needs a parallel.mesh.Mesh, got {type(mesh)}")
    if means3d.device.type != mesh.device.type:
        raise ValueError(f"the splats are on {means3d.device}, the mesh on {mesh.device}")
    camera = camera.to(means3d.device)
    grid_x, grid_y = _grids(camera)
    T = grid_x * grid_y
    tl = -(-T // mesh.size)
    t0 = mesh.rank * tl
    n_total = means3d.shape[0] * mesh.size
    C = payload.shape[1]
    proj = project(means3d, cov3d, camera, screen_tap=screen_tap,
                   opacities=opacities if config.tight_radius else None)
    radii = proj.radius
    proj, pay_f, opac_f = _gather_proj(mesh, proj, payload, opacities)
    stream = config.pallas_input == "stream"
    banded = config.band_intersection_budget > 0
    if banded:  # bin this band's slots only
        proj = clip_rect_rows(proj, t0 // grid_x, (t0 + tl - 1) // grid_x + 1)
        bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, dense=not stream,
                             max_intersections=config.band_intersection_budget,
                             tile_lo=t0, band_size=tl,
                             window_depth=config.tile_windows if stream else 0,
                             window_extra=config.window_extra)
    else:
        bins = _tile_slice(bin_gaussians(proj, grid_x, grid_y, config.max_per_tile,
                                         dense=not stream,
                                         max_intersections=config.fixed_budget(n_total)),
                           t0, tl)
    opac, full_payload = _blend_inputs(proj, opac_f, pay_f)
    accum, t_final = _blend(proj, bins, opac, full_payload, grid_x, config, t0)
    acc = accum.transpose(1, 2)  # [tl, 256, C + 1]
    img = acc[:, :, :C] + t_final[..., None] * bg[None, None, :]
    tiles = torch.cat([img, (1.0 - t_final)[..., None], acc[:, :, C:]], dim=-1)
    full = _untile(_GatherTiles.apply(tiles, mesh)[:T], grid_x, grid_y, camera.height,
                   camera.width)[0]
    n_lost = bins.n_dropped + bins.n_truncated
    if banded:  # each band's own losses
        dist.all_reduce(n_lost, group=mesh.group)
    return full[..., :C], full[..., C], full[..., C + 1], radii, n_lost


def make_sharded_train_step(mesh: Mesh, camera: Camera, config: RasterizeConfig, ocfg,
                            spatial_lr_scale: float = 1.0):
    """A stage-0 step with a fixed camera (parallel/steps.py's stage0):
    step(state, adam, stats, gt, iteration, bg) -> (state, adam, loss,
    image), state and adam this rank's shards; the densification statistics
    it updates are not returned, as in the JAX package."""
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps

    steps = make_sharded_steps(mesh, config, ocfg, spatial_lr_scale)

    def step(state, adam, stats, gt, iteration, bg):
        state, adam, _stats, loss, aux = steps.stage0(state, adam, stats, camera, gt, None,
                                                      iteration, bg)
        return state, adam, loss, aux["image"]

    return step
