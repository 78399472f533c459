"""Differentiable tile rasterizer (port of opengaussian_tpu/ops/rasterize.py).

project -> bin (sorted slot stream) -> per-tile blend -> untile. Any
C-channel payload composites in one pass, with depth appended as one more
channel. The blend is `StreamBlend`, the counterpart of the JAX package's
custom VJP `rasterize_pallas.py:blend_tiles_pallas_stream`: its forward
launches `rasterize_kernels.blend_stream_fwd`, its backward
`blend_stream_bwd` (per-slot gradient rows) and then `segment_reduce`
(per-splat sums). On the CPU each of them runs its plain PyTorch version.

Gradients by means3d, cov3d, opacities, payload and the screen tap flow
through `project` by ordinary autograd; only the blend has its own backward.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import TileBins, bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, Projected, project
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    N_GEOM,
    blend_stream_bwd,
    blend_stream_fwd,
    segment_reduce,
)


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings the port reads (same defaults as the JAX
    package's RasterizeConfig)."""

    max_per_tile: int = 1024  # K: depth-ordered slots kept per tile
    chunk: int = 64  # slots staged per step of the blend
    # opacity-aware cutoff radius (pixel-exact, touches fewer tiles than the
    # classic 3-sigma rect; radii shrink for translucent splats)
    tight_radius: bool = True


@dataclasses.dataclass(frozen=True)
class RasterOut:
    image: torch.Tensor  # [H,W,C] composited payload (premultiplied + T*bg)
    alpha: torch.Tensor  # [H,W] 1 - final transmittance
    depth: torch.Tensor  # [H,W] premultiplied expected depth
    radii: torch.Tensor  # [N] int32, 0 => culled (visibility filter)
    n_dropped: torch.Tensor  # [] int32 budget diagnostics (always 0 here)
    n_truncated: torch.Tensor  # [] int32


def _prepare(camera: Camera, means3d, cov3d, opacities, config: RasterizeConfig,
             screen_tap=None) -> tuple[Projected, TileBins, tuple[int, int]]:
    """Project and bin."""
    grid_x = (camera.width + TILE - 1) // TILE
    grid_y = (camera.height + TILE - 1) // TILE
    proj = project(means3d, cov3d, camera,
                   opacities=opacities if config.tight_radius else None,
                   screen_tap=screen_tap)
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile)
    return proj, bins, (grid_x, grid_y)


@torch.no_grad()
def deepest_tile(camera: Camera, means3d, cov3d, opacities,
                 config: RasterizeConfig) -> int:
    """Slots in this frame's deepest tile, before the max_per_tile cap."""
    _, bins, _ = _prepare(camera.to(means3d.device), means3d, cov3d, opacities, config)
    return int(bins.deepest)


def stream_rows(mean2d, conic, opac, payload, sorted_gauss) -> torch.Tensor:
    """The blend's input rows in sorted-slot order: per slot its splat's
    mean2d (2), conic (3), opacity (1) and payload (C). -> [P, 6 + C]."""
    table = torch.cat([mean2d, conic, opac[:, None], payload], dim=-1)
    return table[sorted_gauss.to(torch.int64)]


class StreamBlend(torch.autograd.Function):
    """Blend of the sorted slot stream with a per-splat backward.

    forward(mean2d [N,2], conic [N,3], opac [N], payload [N,C], sorted_gauss,
    tile_start, counts, toff, grid_x, chunk) -> (accum [T, C, 256],
    t_final [T, 256]). The rows are gathered inside the forward, where
    autograd records nothing (the JAX package's stop_gradient on the carry):
    the backward reduces the per-slot rows to per-splat gradients itself, so
    autograd must not differentiate the gather as well."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, sorted_gauss, tile_start,
                counts, toff, grid_x: int, chunk: int):
        rows = stream_rows(mean2d, conic, opac, payload, sorted_gauss)
        accum, t_final = blend_stream_fwd(rows, counts, tile_start, toff, grid_x,
                                          chunk)
        ctx.save_for_backward(rows, sorted_gauss, tile_start, counts, toff,
                              accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        return accum, t_final

    @staticmethod
    def backward(ctx, g_accum, g_t):
        rows, sorted_gauss, tile_start, counts, toff, accum, t_final = ctx.saved_tensors
        d_rows = blend_stream_bwd(rows, counts, tile_start, toff, accum, t_final,
                                  g_accum.contiguous(), g_t.contiguous(),
                                  ctx.grid_x, ctx.chunk)
        per = segment_reduce(d_rows, sorted_gauss, ctx.n)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None, None, None)


def _untile(x: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int) -> torch.Tensor:
    """[T, 256, ch] tiles -> [H, W, ch]; crops the ragged last tile row and
    column."""
    ch = x.shape[-1]
    x = x.reshape(grid_y, grid_x, TILE, TILE, ch)
    x = x.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, ch)
    return x[:H, :W]


def _images(camera: Camera, grids, accum, t_final, bg):
    """accum [T, C+1, 256] (payload + depth), t_final [T, 256] -> image
    [H,W,C] over bg, alpha [H,W], depth [H,W]."""
    grid_x, grid_y = grids
    acc = accum.transpose(1, 2)  # [T, 256, C+1]
    C = acc.shape[-1] - 1
    img_tiles = acc[:, :, :C] + t_final[..., None] * bg[None, None, :]
    H, W = camera.height, camera.width
    image = _untile(img_tiles, grid_x, grid_y, H, W)
    alpha = _untile((1.0 - t_final)[..., None], grid_x, grid_y, H, W)[..., 0]
    depth = _untile(acc[:, :, C:], grid_x, grid_y, H, W)[..., 0]
    return image, alpha, depth


def _composite(camera: Camera, proj: Projected, bins: TileBins, grids,
               opacities, payload, bg, config: RasterizeConfig):
    grid_x, grid_y = grids
    toff = torch.arange(grid_x * grid_y, dtype=torch.int32,
                        device=bins.counts.device)
    opac = torch.where(proj.valid, opacities, 0.0)
    full_payload = torch.cat([payload, proj.depth[:, None]], dim=-1)
    accum, t_final = StreamBlend.apply(
        proj.mean2d, proj.conic, opac, full_payload, bins.sorted_gauss,
        bins.tile_start, bins.counts, toff, grid_x, config.chunk)
    return _images(camera, grids, accum, t_final, bg)


def rasterize(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    screen_tap: torch.Tensor | None = None,
) -> RasterOut:
    """Render a per-splat payload [N, C] to an [H, W, C] image, plus alpha,
    premultiplied depth and per-splat radii. screen_tap [N, 2]: zeros added
    to the NDC position, whose gradient is the densification signal."""
    camera = camera.to(means3d.device)
    proj, bins, grids = _prepare(camera, means3d, cov3d, opacities, config,
                                 screen_tap)
    image, alpha, depth = _composite(camera, proj, bins, grids, opacities,
                                     payload, bg, config)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated)
