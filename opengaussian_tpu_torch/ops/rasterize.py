"""Differentiable tile rasterizer (port of opengaussian_tpu/ops/rasterize.py).

project -> bin (sorted slot stream) -> per-tile blend -> untile. Any
C-channel payload composites in one pass, with depth appended as one more
channel. The blend takes one of two input layouts, as in the JAX package
(`RasterizeConfig.pallas_input`):
  * "stream" (default): `StreamBlend`, the counterpart of the custom VJP
    `rasterize_pallas.py:blend_tiles_pallas_stream`. Its forward launches
    `rasterize_kernels.blend_stream_fwd` (K1) on the sorted slot rows. Its
    backward launches `blend_stream_bwd` (K2, per-slot gradient rows at the
    stream positions) or, with `bwd_layout="compact"`,
    `blend_stream_bwd_compact` (K4, the same rows compacted by chunk with
    their splat ids), and then `segment_reduce` (K3, per-splat sums).
  * "dense": `DenseBlend`, the counterpart of the custom VJP
    `blend_tiles_pallas`. Its forward gathers a [T, K, 6 + C] block and
    launches `blend_tiles_fwd` (K5), its backward `blend_tiles_bwd` (K6,
    the live rows at their stream positions, as K2 gives them) and then
    `segment_reduce` over those rows with the stream's ids.
All give the same images and gradients. On the CPU each kernel runs its
plain PyTorch version.

Group renders (stage 2.2, the pseudo-label sweeps, stage 3) render G subsets
of one scene: `rasterize_scan_groups` re-bins each group with its own masked
opacities under one shared projection and depth rank (any layout, with
gradients); `rasterize_partition` renders G disjoint groups with one
binning over G x T virtual tiles and one K1 launch (stream layout).

Gradients by means3d, cov3d, opacities, payload and the screen tap flow
through `project` by ordinary autograd; only the blend has its own backward.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import TileBins, bin_gaussians, depth_rank
from opengaussian_tpu_torch.ops.projection import TILE, Projected, project
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    N_GEOM,
    blend_stream_bwd,
    blend_stream_bwd_compact,
    blend_stream_fwd,
    blend_tiles_bwd,
    blend_tiles_fwd,
    segment_reduce,
)

LAYOUTS = ("stream", "dense")
BWD_LAYOUTS = ("auto", "dense", "compact")
GROUP_RENDERS = ("auto", "scan")


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
    # the stream backward's rows: "auto" and "dense" = K2, rows at the stream
    # positions (the JAX package's [T, K, F] block and chunk gather give the
    # same per-splat sums); "compact" = K4, rows compacted by chunk with
    # their splat ids
    bwd_layout: str = "auto"
    # group renders: "auto" and "scan" = rasterize_scan_groups. The JAX
    # package's "dense" (one union binning, the blend batched over groups)
    # is not ported
    group_render: str = "auto"

    def __post_init__(self):
        if self.chunk <= 0 or self.max_per_tile % self.chunk:
            raise ValueError("max_per_tile must be a multiple of chunk")
        if self.pallas_input not in LAYOUTS:
            raise ValueError(f"pallas_input must be one of {LAYOUTS}, got "
                             f"{self.pallas_input!r}")
        if self.bwd_layout not in BWD_LAYOUTS:
            raise ValueError(f"bwd_layout must be one of {BWD_LAYOUTS}, got "
                             f"{self.bwd_layout!r}")
        if self.group_render == "dense":
            raise NotImplementedError(
                "group_render='dense' (rasterize_groups, the blend batched over "
                "groups on the dense layout) arrives with a later slice of the "
                "port; see ROADMAP.md")
        if self.group_render not in GROUP_RENDERS:
            raise ValueError(f"group_render must be one of {GROUP_RENDERS}, got "
                             f"{self.group_render!r}")


@dataclasses.dataclass(frozen=True)
class RasterOut:
    image: torch.Tensor  # [H,W,C] composited payload (premultiplied + T*bg)
    alpha: torch.Tensor  # [H,W] 1 - final transmittance
    depth: torch.Tensor  # [H,W] premultiplied expected depth
    radii: torch.Tensor  # [N] int32, 0 => culled (visibility filter)
    n_dropped: torch.Tensor  # [] int32 budget diagnostics (always 0 here)
    n_truncated: torch.Tensor  # [] int32


def _grids(camera: Camera) -> tuple[int, int]:
    return (camera.width + TILE - 1) // TILE, (camera.height + TILE - 1) // TILE


def _project(camera: Camera, means3d, cov3d, opacities, config: RasterizeConfig,
             screen_tap=None) -> Projected:
    return project(means3d, cov3d, camera,
                   opacities=opacities if config.tight_radius else None,
                   screen_tap=screen_tap)


def _prepare(camera: Camera, means3d, cov3d, opacities, config: RasterizeConfig,
             screen_tap=None, proj: Projected | None = None,
             rank: torch.Tensor | None = None) -> tuple[Projected, TileBins, tuple[int, int]]:
    """Project (unless proj is given) and bin."""
    grid_x, grid_y = _grids(camera)
    if proj is None:
        proj = _project(camera, means3d, cov3d, opacities, config, screen_tap)
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile,
                         dense=config.pallas_input == "dense", rank=rank)
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
    tile_start, counts, toff, grid_x, chunk, bwd_layout) -> (accum
    [T, C, 256], t_final [T, 256]). The rows are gathered inside the
    forward, where autograd records nothing (the JAX package's stop_gradient
    on the carry): the backward reduces the per-slot rows to per-splat
    gradients itself, so autograd must not differentiate the gather as well.
    The backward takes the rows from K2 (at the stream positions, ids from
    sorted_gauss) or, for bwd_layout "compact", from K4 (compacted, with
    their ids), and sums them per splat with K3."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, sorted_gauss, tile_start,
                counts, toff, grid_x: int, chunk: int, bwd_layout: str = "auto"):
        rows = gather_rows(mean2d, conic, opac, payload, sorted_gauss)
        accum, t_final = blend_stream_fwd(rows, counts, tile_start, toff, grid_x,
                                          chunk)
        ctx.save_for_backward(rows, sorted_gauss, tile_start, counts, toff,
                              accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        ctx.compact = bwd_layout == "compact"
        return accum, t_final

    @staticmethod
    def backward(ctx, g_accum, g_t):
        rows, sorted_gauss, tile_start, counts, toff, accum, t_final = ctx.saved_tensors
        cot = (accum, t_final, g_accum.contiguous(), g_t.contiguous(), ctx.grid_x,
               ctx.chunk)
        if ctx.compact:
            d_rows, ids = blend_stream_bwd_compact(rows, counts, tile_start, toff,
                                                   sorted_gauss, *cot, ctx.n)
        else:
            d_rows = blend_stream_bwd(rows, counts, tile_start, toff, *cot)
            ids = sorted_gauss
        per = segment_reduce(d_rows, ids, ctx.n)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None, None, None, None)


class DenseBlend(torch.autograd.Function):
    """Blend of a dense [T, K] layout with a per-splat backward (the JAX
    package's custom VJP rasterize_pallas.py:blend_tiles_pallas).

    forward(mean2d [N,2], conic [N,3], opac [N], payload [N,C], gauss_idx
    [T,K], sorted_gauss [P], tile_start [T], counts [T], grid_x, chunk) ->
    (accum [T, C, 256], t_final [T, 256]). The block gdata [T, K, 6+C] is
    gathered inside the forward, where autograd records nothing, as in
    StreamBlend. The backward takes the live rows from the K6 replay, at
    the stream positions tile_start[t] + k the block was gathered from, and
    sums them per splat with K3 by sorted_gauss: P rows, not T x K."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, gauss_idx, sorted_gauss, tile_start,
                counts, grid_x: int, chunk: int):
        gdata = gather_rows(mean2d, conic, opac, payload, gauss_idx)
        accum, t_final = blend_tiles_fwd(gdata, counts, grid_x, chunk)
        ctx.save_for_backward(gdata, sorted_gauss, tile_start, counts, accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        return accum, t_final

    @staticmethod
    def backward(ctx, g_accum, g_t):
        gdata, sorted_gauss, tile_start, counts, accum, t_final = ctx.saved_tensors
        d_rows = blend_tiles_bwd(gdata, counts, tile_start, sorted_gauss.shape[0], accum,
                                 t_final, g_accum.contiguous(), g_t.contiguous(),
                                 ctx.grid_x, ctx.chunk)
        per = segment_reduce(d_rows, sorted_gauss, ctx.n)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None, None, None)


def _untile(x: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int) -> torch.Tensor:
    """[G * T, 256, ch] tiles -> [G, H, W, ch] (G = 1 for [T, ...]); crops the
    ragged last tile row and column."""
    ch = x.shape[-1]
    x = x.reshape(-1, grid_y, grid_x, TILE, TILE, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, grid_y * TILE, grid_x * TILE, ch)
    return x[:, :H, :W]


def _images(camera: Camera, grids, accum, t_final, bg):
    """accum [G * T, C+1, 256] (payload + depth), t_final [G * T, 256] ->
    image [G, H, W, C] over bg, alpha [G, H, W], depth [G, H, W]."""
    grid_x, grid_y = grids
    acc = accum.transpose(1, 2)  # [G * T, 256, C+1]
    C = acc.shape[-1] - 1
    img_tiles = acc[:, :, :C] + t_final[..., None] * bg[None, None, :]
    H, W = camera.height, camera.width
    image = _untile(img_tiles, grid_x, grid_y, H, W)
    alpha = _untile((1.0 - t_final)[..., None], grid_x, grid_y, H, W)[..., 0]
    depth = _untile(acc[:, :, C:], grid_x, grid_y, H, W)[..., 0]
    return image, alpha, depth


def _blend_inputs(proj: Projected, opacities, payload):
    """The blend's per-splat columns: opacity 0 where the projection culled,
    and depth appended to the payload."""
    opac = torch.where(proj.valid, opacities, 0.0)
    return opac, torch.cat([payload, proj.depth[:, None]], dim=-1)


def _composite(camera: Camera, proj: Projected, bins: TileBins, grids,
               opacities, payload, bg, config: RasterizeConfig):
    grid_x, grid_y = grids
    opac, full_payload = _blend_inputs(proj, opacities, payload)
    if config.pallas_input == "dense":
        accum, t_final = DenseBlend.apply(
            proj.mean2d, proj.conic, opac, full_payload, bins.gauss_idx,
            bins.sorted_gauss, bins.tile_start, bins.counts, grid_x, config.chunk)
    else:
        toff = torch.arange(grid_x * grid_y, dtype=torch.int32,
                            device=bins.counts.device)
        accum, t_final = StreamBlend.apply(
            proj.mean2d, proj.conic, opac, full_payload, bins.sorted_gauss,
            bins.tile_start, bins.counts, toff, grid_x, config.chunk, config.bwd_layout)
    image, alpha, depth = _images(camera, grids, accum, t_final, bg)
    return image[0], alpha[0], depth[0]


def rasterize(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    screen_tap: torch.Tensor | None = None,
    proj: Projected | None = None,
    rank: torch.Tensor | None = None,
) -> RasterOut:
    """Render a per-splat payload [N, C] to an [H, W, C] image, plus alpha,
    premultiplied depth and per-splat radii. screen_tap [N, 2]: zeros added
    to the NDC position, whose gradient is the densification signal.
    proj / rank: a projection and depth rank computed once outside, which
    group renders share across their groups."""
    camera = camera.to(means3d.device)
    proj, bins, grids = _prepare(camera, means3d, cov3d, opacities, config,
                                 screen_tap, proj, rank)
    image, alpha, depth = _composite(camera, proj, bins, grids, opacities,
                                     payload, bg, config)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated)


def cull_outside(proj: Projected, keep: torch.Tensor) -> Projected:
    """proj with the splats outside `keep` culled: radius, cull radius,
    tiles and validity zeroed. Kept splats keep every field, and their
    autograd path, as they were."""
    return dataclasses.replace(
        proj, radius=torch.where(keep, proj.radius, 0),
        cull_radius=torch.where(keep, proj.cull_radius, 0.0),
        num_tiles=torch.where(keep, proj.num_tiles, 0), valid=proj.valid & keep)


def rasterize_scan_groups(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,  # [G, N] per-group masked opacities
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
) -> RasterOut:
    """Render G subsets of one scene, one group after the other (the JAX
    package's lax.scan of single-group rasterizes, rasterize.py:666).

    One projection, at the union of the groups' opacities, and one depth
    rank serve every group: a member's masked opacity is its real opacity,
    so its projected fields are what a per-group projection would give, and
    a non-member is culled (`cull_outside`). Each group then bins only its own
    splats and blends them in any layout; gradients flow as through
    `rasterize`. -> RasterOut with image [G, H, W, C], alpha and depth
    [G, H, W]; radii the maximum over groups, n_dropped / n_truncated the
    sums."""
    camera = camera.to(means3d.device)
    union = opacities.max(dim=0).values
    proj_u = _project(camera, means3d, cov3d, union, config)
    rank = depth_rank(proj_u.depth.detach())
    outs = [rasterize(camera, means3d, cov3d, opac_g, payload, bg, config,
                      proj=cull_outside(proj_u, opac_g > 0.0), rank=rank)
            for opac_g in opacities]
    return RasterOut(
        image=torch.stack([r.image for r in outs]),
        alpha=torch.stack([r.alpha for r in outs]),
        depth=torch.stack([r.depth for r in outs]),
        radii=torch.stack([r.radii for r in outs]).max(dim=0).values,
        n_dropped=sum(r.n_dropped for r in outs),
        n_truncated=sum(r.n_truncated for r in outs))


def rasterize_partition(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,  # [N] union-masked (0 for splats in no group)
    group_of: torch.Tensor,  # [N] int group of each splat, 0..G-1
    num_groups: int,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    proj: Projected | None = None,
    rank: torch.Tensor | None = None,
) -> RasterOut:
    """Render G disjoint groups (a cluster partition) in one pass (the JAX
    package's rasterize.py:747).

    Partition binning (`bin_gaussians(group_of=...)`) puts each slot in the
    virtual tile group_of * T + tile, so one expansion, one sort and one K1
    launch over G * T virtual tiles (pixels of tile vt % T) cover every
    group; each virtual tile's run holds exactly the slots a single-group
    binning gives. Splats outside every group must be culled in proj (zero
    opacity, or proj masked by the caller). Stream layout only.
    -> RasterOut with image [G, H, W, C], alpha and depth [G, H, W], the
    union's radii."""
    if config.pallas_input != "stream":
        raise ValueError("rasterize_partition needs pallas_input='stream'")
    camera = camera.to(means3d.device)
    grid_x, grid_y = _grids(camera)
    T = grid_x * grid_y
    if proj is None:
        proj = _project(camera, means3d, cov3d, opacities, config)
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, rank=rank,
                         group_of=group_of, num_groups=num_groups)
    opac, full_payload = _blend_inputs(proj, opacities, payload)
    toff = (torch.arange(num_groups * T, device=bins.counts.device) % T).to(torch.int32)
    accum, t_final = StreamBlend.apply(
        proj.mean2d, proj.conic, opac, full_payload, bins.sorted_gauss, bins.tile_start,
        bins.counts, toff, grid_x, config.chunk, config.bwd_layout)
    image, alpha, depth = _images(camera, (grid_x, grid_y), accum, t_final, bg)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated)
