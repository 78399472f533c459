"""Differentiable tile rasterizer (port of opengaussian_tpu/ops/rasterize.py).

project -> bin (sorted slot stream) -> per-tile blend -> untile. Any
C-channel payload composites in one pass, with depth appended as one more
channel. The blend takes one of two input layouts, as in the JAX package
(`RasterizeConfig.pallas_input`):
  * "stream" (default): `StreamBlend`, the counterpart of the custom VJP
    `rasterize_pallas.py:blend_tiles_pallas_stream`. Its forward launches
    `rasterize_kernels.blend_stream_fwd` (K1) on the sorted slot rows, its
    backward `blend_stream_bwd` (K2, per-slot gradient rows) and then
    `segment_reduce` (K3, per-splat sums).
  * "dense": `DenseBlend`, the counterpart of the custom VJP
    `blend_tiles_pallas`. Its forward gathers a [T, K, 6 + C] block and
    launches `blend_tiles_fwd` (K5), its backward `blend_tiles_bwd` (K6,
    d_slot [T, K, 6 + C]) and then `segment_reduce` over the block's rows.
Both give the same images and gradients. On the CPU each kernel runs its
plain PyTorch version.

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
    blend_tiles_bwd,
    blend_tiles_fwd,
    segment_reduce,
)

LAYOUTS = ("stream", "dense")


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings the port reads (same defaults as the JAX
    package's RasterizeConfig)."""

    max_per_tile: int = 1024  # K: depth-ordered slots kept per tile
    chunk: int = 64  # slots staged per step of the blend
    # opacity-aware cutoff radius (pixel-exact, touches fewer tiles than the
    # classic 3-sigma rect; radii shrink for translucent splats)
    tight_radius: bool = True
    # blend input layout: "stream" = the kernels read each tile's run out of
    # the sorted slot stream; "dense" = a [T, K, 6 + C] block gathered per
    # tile (the JAX package's field of the same name)
    pallas_input: str = "stream"

    def __post_init__(self):
        if self.chunk <= 0 or self.max_per_tile % self.chunk:
            raise ValueError("max_per_tile must be a multiple of chunk")
        if self.pallas_input not in LAYOUTS:
            raise ValueError(f"pallas_input must be one of {LAYOUTS}, got "
                             f"{self.pallas_input!r}")


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
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile,
                         dense=config.pallas_input == "dense")
    return proj, bins, (grid_x, grid_y)


@torch.no_grad()
def deepest_tile(camera: Camera, means3d, cov3d, opacities,
                 config: RasterizeConfig) -> int:
    """Slots in this frame's deepest tile, before the max_per_tile cap."""
    config = dataclasses.replace(config, pallas_input="stream")  # no [T, K] matrix
    _, bins, _ = _prepare(camera.to(means3d.device), means3d, cov3d, opacities, config)
    return int(bins.deepest)


def gather_rows(mean2d, conic, opac, payload, idx) -> torch.Tensor:
    """The blend's input rows: for each slot of idx (any shape), its splat's
    mean2d (2), conic (3), opacity (1) and payload (C). -> [*idx.shape, 6 + C].
    With the stream's sorted_gauss [P] these are the sorted slot rows; with
    the dense gauss_idx [T, K] the block `gdata` (the JAX package's
    rasterize_pallas.py:_make_gdata)."""
    table = torch.cat([mean2d, conic, opac[:, None], payload], dim=-1)
    return table[idx.to(torch.int64)]


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
        rows = gather_rows(mean2d, conic, opac, payload, sorted_gauss)
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


class DenseBlend(torch.autograd.Function):
    """Blend of a dense [T, K] layout with a per-splat backward (the JAX
    package's custom VJP rasterize_pallas.py:blend_tiles_pallas).

    forward(mean2d [N,2], conic [N,3], opac [N], payload [N,C], gauss_idx
    [T,K], counts [T], grid_x, chunk) -> (accum [T, C, 256], t_final
    [T, 256]). The block gdata [T, K, 6+C] is gathered inside the forward,
    where autograd records nothing, as in StreamBlend. The backward takes
    d_slot [T, K, 6+C] from the K6 replay and sums its rows per splat with
    K3; slots k >= counts[t] hold splat 0 in gauss_idx, so their ids are set
    to n, which the reduce drops."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, gauss_idx, counts, grid_x: int,
                chunk: int):
        gdata = gather_rows(mean2d, conic, opac, payload, gauss_idx)
        accum, t_final = blend_tiles_fwd(gdata, counts, grid_x, chunk)
        ctx.save_for_backward(gdata, gauss_idx, counts, accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        return accum, t_final

    @staticmethod
    def backward(ctx, g_accum, g_t):
        gdata, gauss_idx, counts, accum, t_final = ctx.saved_tensors
        d_slot = blend_tiles_bwd(gdata, counts, accum, t_final, g_accum.contiguous(),
                                 g_t.contiguous(), ctx.grid_x, ctx.chunk)
        T, K, F = gdata.shape
        live = torch.arange(K, device=counts.device)[None, :] < counts[:, None]
        ids = torch.where(live, gauss_idx, ctx.n).to(torch.int32)
        per = segment_reduce(d_slot.view(T * K, F), ids.view(T * K), ctx.n)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None)


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
    opac = torch.where(proj.valid, opacities, 0.0)
    full_payload = torch.cat([payload, proj.depth[:, None]], dim=-1)
    if config.pallas_input == "dense":
        accum, t_final = DenseBlend.apply(
            proj.mean2d, proj.conic, opac, full_payload, bins.gauss_idx, bins.counts,
            grid_x, config.chunk)
    else:
        toff = torch.arange(grid_x * grid_y, dtype=torch.int32,
                            device=bins.counts.device)
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
