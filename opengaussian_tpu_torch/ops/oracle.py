"""Naive per-pixel oracle rasterizer (port of opengaussian_tpu/ops/oracle.py).

Test-only ground truth for the tile rasterizer: depth-sorts all splats
globally and walks them front to back for every pixel at once, applying the
blend rules of ops/blend.py one splat at a time. A pixel sees a splat only
if the splat's tile rect covers the pixel's tile, as in the tile rasterizer.
Uses the classic 3-sigma radius (no opacity-aware cutoff).
"""

from __future__ import annotations

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops import blend
from opengaussian_tpu_torch.ops.projection import TILE, project


def rasterize_oracle(camera: Camera, means3d, cov3d, opacities, colors, bg):
    """colors [N, C], opacities [N], bg [C] ->
    dict(image [H,W,C], alpha [H,W], depth [H,W], radii [N])."""
    camera = camera.to(means3d.device)
    dev = means3d.device
    H, W = camera.height, camera.width
    proj = project(means3d, cov3d, camera)

    depth_key = torch.where(proj.valid, proj.depth, torch.inf)
    order = torch.argsort(depth_key, stable=True)

    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32)
    tile_x = pix[:, 0].to(torch.int32) // TILE
    tile_y = pix[:, 1].to(torch.int32) // TILE

    trans = torch.ones(H * W, device=dev)
    done = torch.zeros(H * W, dtype=torch.bool, device=dev)
    image = torch.zeros(H * W, colors.shape[1], device=dev)
    depth = torch.zeros(H * W, device=dev)
    for i in order.tolist():
        if not bool(proj.valid[i]):
            break  # culled splats sort last
        rmin, rmax = proj.rect_min[i], proj.rect_max[i]
        in_rect = ((tile_x >= rmin[0]) & (tile_x < rmax[0])
                   & (tile_y >= rmin[1]) & (tile_y < rmax[1]))
        a = blend.alpha_from_conic(proj.mean2d[i][None], proj.conic[i][None],
                                   opacities[i][None], pix)[0]
        a = torch.clamp(a, max=blend.ALPHA_MAX)
        live = in_rect & ~done & (a >= blend.ALPHA_MIN)
        t_next = trans * (1.0 - a)
        done = done | (live & (t_next < blend.T_EPS))
        live = live & (t_next >= blend.T_EPS)
        w = torch.where(live, a * trans, 0.0)
        image = image + w[:, None] * colors[i]
        depth = depth + w * proj.depth[i]
        trans = torch.where(live, t_next, trans)
    image = image + trans[:, None] * bg
    return dict(
        image=image.reshape(H, W, -1),
        alpha=(1.0 - trans).reshape(H, W),
        depth=depth.reshape(H, W),
        radii=proj.radius,
    )
