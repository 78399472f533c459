"""Tile rasterizer, forward only (port of opengaussian_tpu/ops/rasterize.py).

project -> bin (sorted slot stream) -> per-tile blend -> untile. The blend
is `rasterize_kernels.blend_stream_fwd`: the CUDA kernel on the GPU, its
plain PyTorch version on the CPU. Any C-channel payload composites in one
pass, with depth appended as one more channel.

Gradients come with the training slice of the port, which adds the
backward kernels; until then a call that would need them raises.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import TileBins, bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, Projected, project
from opengaussian_tpu_torch.ops.rasterize_kernels import blend_stream_fwd


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings this forward path reads (same defaults as the
    JAX package's RasterizeConfig)."""

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


def _prepare(camera: Camera, means3d, cov3d, opacities, payload,
             config: RasterizeConfig) -> tuple[Projected, TileBins, tuple[int, int]]:
    """Project and bin; the blend rows ride the sort as `sorted_carry`:
    mean2d (2), conic (3), masked opacity (1), payload (C), depth (1)."""
    grid_x = (camera.width + TILE - 1) // TILE
    grid_y = (camera.height + TILE - 1) // TILE
    proj = project(means3d, cov3d, camera,
                   opacities=opacities if config.tight_radius else None)
    opac_m = torch.where(proj.valid, opacities, 0.0)
    carry = torch.cat([proj.mean2d, proj.conic, opac_m[:, None], payload,
                       proj.depth[:, None]], dim=-1)
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, carry=carry)
    return proj, bins, (grid_x, grid_y)


def _untile(x: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int) -> torch.Tensor:
    """[T, 256, ch] tiles -> [H, W, ch]; crops the ragged last tile row and
    column."""
    ch = x.shape[-1]
    x = x.reshape(grid_y, grid_x, TILE, TILE, ch)
    x = x.permute(0, 2, 1, 3, 4).reshape(grid_y * TILE, grid_x * TILE, ch)
    return x[:H, :W]


def _composite(camera: Camera, bins: TileBins, grids, n_channels: int, bg,
               config: RasterizeConfig):
    grid_x, grid_y = grids
    toff = torch.arange(grid_x * grid_y, dtype=torch.int32,
                        device=bins.counts.device)
    acc, t_final = blend_stream_fwd(bins.sorted_carry, bins.counts,
                                    bins.tile_start, toff, grid_x, config.chunk)
    accum = acc.transpose(1, 2)  # [T, 256, C+1]
    C = n_channels
    img_tiles = accum[:, :, :C] + t_final[..., None] * bg[None, None, :]
    H, W = camera.height, camera.width
    image = _untile(img_tiles, grid_x, grid_y, H, W)
    alpha = _untile((1.0 - t_final)[..., None], grid_x, grid_y, H, W)[..., 0]
    depth = _untile(accum[:, :, C:], grid_x, grid_y, H, W)[..., 0]
    return image, alpha, depth


def rasterize(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
) -> RasterOut:
    """Render a per-splat payload [N, C] to an [H, W, C] image, plus alpha,
    premultiplied depth and per-splat radii."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (means3d, cov3d, opacities, payload, bg)):
        raise NotImplementedError(
            "rasterize is forward only: gradients arrive with the port's "
            "training slice (the backward kernels K2/K3); call it under "
            "torch.no_grad() or on tensors that do not require grad")
    camera = camera.to(means3d.device)
    proj, bins, grids = _prepare(camera, means3d, cov3d, opacities, payload,
                                 config)
    image, alpha, depth = _composite(camera, bins, grids, payload.shape[1],
                                     bg, config)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated)
