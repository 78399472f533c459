"""The SAM refiner's device passes over a device mesh (port of
opengaussian_tpu/parallel/refine.py).

The refiner (refine/sam_refiner.py) makes three device passes per view: the
depth render, the footprint-weighted id votes and the stage-2 pixel weights.
Under `Trainer(mesh=...)` they run with the splat table sharded:

  * each rank projects its own splats; the projected table is gathered
    once per pass and binned on every rank alike, densely at
    config.max_per_tile (the footprint binning of the single-device passes,
    truncated alike);
  * the depth render is parallel/render.py:render_sharded of a zero payload
    (K1 at C = 2, or K5, at the rank's tile offset), as the single-device
    refiner renders it through `rasterize`;
  * the votes: each rank contracts the footprint alphas of its own tiles
    with the one-hot SAM ids, and the [N, M] votes are summed over the mesh
    (the ranks' tiles are disjoint);
  * the pixel weights: each rank accumulates its own tiles, and the tiles
    are gathered into the whole [H, W, M] volume.

Every output is the same on every rank: the host's graph merge, which every
rank runs alike, reads them.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _grids, _untile
from opengaussian_tpu_torch.parallel.mesh import Mesh, all_gather
from opengaussian_tpu_torch.parallel.render import (
    _gather_proj,
    _rows,
    _tile_slice,
    render_sharded,
)
from opengaussian_tpu_torch.refine.sam_refiner import (
    DEPTH_THRESHOLD,
    _chunk_alphas,
    _tile_pixels,
    _tile_sam_onehot,
    fp32_matmuls,
)


def make_refiner_fns(mesh: Mesh, config: RasterizeConfig) -> SimpleNamespace:
    """-> a namespace of the sharded depth_votes and pixel_weights, for
    refine_sam_masks(sharded_fns=...); `mesh` rides along for the refiner's
    gathers of the splat vectors. Every rank calls each with its own shard
    of the state and the same view."""

    def _project_bin(camera: Camera, means, cov, opac):
        """The footprint pass's phase 1: this rank's splats projected with no
        opacities, the table gathered and binned densely at
        config.max_per_tile. -> (proj [N], opac [N] gathered, bins of this
        rank's tiles, pix [tl, 256, 2], (grid_x, grid_y))."""
        grid_x, grid_y = _grids(camera)
        tl = -(-grid_x * grid_y // mesh.size)
        proj = project(means, cov, camera)
        proj, _pay, opac_f = _gather_proj(mesh, proj, means[:, :0], opac)
        bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, dense=True,
                             max_intersections=config.fixed_budget(opac_f.shape[0]))
        pix = _rows(_tile_pixels(grid_x, grid_y, means.device), mesh.rank * tl, tl)
        return proj, opac_f, _tile_slice(bins, mesh.rank * tl, tl), pix, (grid_x, grid_y)

    @torch.no_grad()
    @fp32_matmuls()
    def depth_votes(gs, camera: Camera, sam_ids, max_ids: int):
        """-> (votes [N, max_ids], visible [N], depth [H, W]): the refiner's
        depth render and sam_refiner.splat_id_votes over the mesh, N the
        whole table's splats, the same on every rank."""
        camera = camera.to(gs.device)
        H, W = camera.height, camera.width
        cov = build_cov3d(gs.scales, gs.quats)
        zeros = torch.zeros((gs.capacity, 1), device=gs.device)
        _img, alpha, depth, _r, _l = render_sharded(mesh, camera, gs.means, cov, gs.opacity,
                                                    zeros, torch.zeros(1, device=gs.device),
                                                    config)
        depth = depth / torch.clamp(alpha, min=1e-6)
        opac = torch.where(gs.alive, gs.opacity, 0.0)
        proj, opac_f, bins, pix, (grid_x, grid_y) = _project_bin(camera, gs.means, cov, opac)
        cx = torch.clamp(proj.mean2d[:, 0].to(torch.int32), 0, W - 1).to(torch.int64)
        cy = torch.clamp(proj.mean2d[:, 1].to(torch.int32), 0, H - 1).to(torch.int64)
        visible = proj.valid & ((proj.depth - depth[cy, cx]).abs() < DEPTH_THRESHOLD)
        tl = pix.shape[0]
        onehot = _rows(_tile_sam_onehot(sam_ids, grid_x, grid_y, max_ids), mesh.rank * tl, tl)
        opac_f = torch.where(proj.valid, opac_f, 0.0)
        votes = torch.zeros((opac_f.shape[0], max_ids), device=gs.device)
        for ids, a in _chunk_alphas(proj, bins, opac_f, pix, config):
            votes.index_add_(0, ids.reshape(-1), torch.bmm(a, onehot).reshape(-1, max_ids))
        dist.all_reduce(votes, group=mesh.group)
        return votes, visible, depth

    @torch.no_grad()
    @fp32_matmuls()
    def pixel_weights(gs, camera: Camera, splat_gid, contrib, synced_mask, n_match,
                      max_ids: int):
        """-> weights [H, W, max_ids]: sam_refiner.pixel_weight_accumulation
        over the mesh, the same on every rank. splat_gid and contrib [N]: the
        whole table's (the host computes them for every splat)."""
        camera = camera.to(gs.device)
        H, W = camera.height, camera.width
        n = gs.capacity
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        gid_l, con_l = splat_gid[rows], contrib[rows]
        opac = torch.where(gs.alive & con_l & (gid_l > 0), gs.opacity, 0.0)
        proj, opac_f, bins, pix, (grid_x, grid_y) = _project_bin(
            camera, gs.means, build_cov3d(gs.scales, gs.quats), opac)
        opac_f = torch.where(proj.valid, opac_f, 0.0)
        ids_m = torch.arange(1, max_ids + 1, device=gs.device)
        acc = torch.zeros((pix.shape[0], TILE * TILE, max_ids), device=gs.device)
        for ids, a in _chunk_alphas(proj, bins, opac_f, pix, config):
            onehot = (splat_gid[ids][:, :, None] == ids_m).to(torch.float32)
            acc.baddbmm_(a.transpose(1, 2), onehot)  # += tkp,tkm->tpm
        acc = _untile(all_gather(acc, mesh)[:grid_x * grid_y], grid_x, grid_y, H, W)[0]
        base = synced_mask[:, :, None] == ids_m
        return torch.where(base, 1.0 + n_match, acc)

    return SimpleNamespace(depth_votes=depth_votes, pixel_weights=pixel_weights, mesh=mesh)
