"""The pseudo-label sweeps and the stage-3 association over a device mesh
(port of opengaussian_tpu/parallel/sweeps.py).

Under `Trainer(mesh=...)` the splat table stays sharded through the
stage-boundary sweeps too: routing them through the single-device renders
would gather the whole table onto one device per call. Here:

  * `render_groups_sharded` renders G groups of one scene: each rank
    projects its own splats, the projected table is gathered once and
    binned densely (every rank alike), and each rank blends its own range
    of tiles for all G groups in one launch of the group entry of K5
    (`rasterize_kernels.blend_tiles_fwd_groups`, at the rank's tile offset),
    with the [G, N] opacities gathered along the splat axis; the tiles are
    gathered into whole images;
  * `make_sweep_fns` gives sweep 1, sweep 2 and the stage-3 association of
    one view with the semantics of train/pseudo.py and train/lang.py (their
    post-render math is shared), for `construct_pseudo_labels(sweep_fns=)`
    and `associate_language(view_fn=)`. The association gathers the
    N-sized vectors once per view, never once per root: each rank blends
    its own tiles for every root and sums, over its own pixels, what the
    leaf scores read (each leaf's silhouette area and feature sum and its
    overlap with every pseudo mask); one all-reduce of those sums per view
    gives every rank the whole image's.

The sweeps are forward only: they blend the dense layout's block with no
backward.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops import rasterize_kernels as rk
from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _grids, _untile, gather_rows
from opengaussian_tpu_torch.parallel.mesh import Mesh, all_gather
from opengaussian_tpu_torch.parallel.render import (
    _gather_proj,
    _rows,
    _tile_slice,
    render_sharded,
)
from opengaussian_tpu_torch.refine.sam_refiner import _tile_sam_onehot
from opengaussian_tpu_torch.render import (
    COARSE_SCALE_LIMIT,
    MIN_CLUSTER_POINTS,
    OCCUR_SIL_THRESHOLD,
    encoded_ins_feat,
)
from opengaussian_tpu_torch.train import lang as lang_mod
from opengaussian_tpu_torch.train import pseudo as pseudo_mod
from opengaussian_tpu_torch.utils import masks as masku


def _project_gather_bin(mesh: Mesh, camera: Camera, means3d, cov3d, opac, payload,
                        config: RasterizeConfig):
    """Project this rank's splats (tightened by opac under
    config.tight_radius), gather the table and bin it densely at the frame
    budgets, cut to this rank's tiles. -> (proj [N], payload with depth
    appended [N, C + 1], bins of tiles [t0, t0 + tl), t0, grid_x, grid_y)."""
    grid_x, grid_y = _grids(camera)
    tl = -(-grid_x * grid_y // mesh.size)
    t0 = mesh.rank * tl
    proj = project(means3d, cov3d, camera, opacities=opac if config.tight_radius else None)
    proj, pay_f, _ = _gather_proj(mesh, proj, payload, opac)
    bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, dense=True,
                         max_intersections=config.fixed_budget(proj.mean2d.shape[0]))
    full_pay = torch.cat([pay_f, proj.depth[:, None]], dim=-1)
    return proj, full_pay, _tile_slice(bins, t0, tl), t0, grid_x, grid_y


def _block(proj, full_pay, bins) -> torch.Tensor:
    """The dense block [tl, K, 6 + C + 1] of this rank's tiles (its opacity
    column unused: the group entry reads each group's by splat id)."""
    n = proj.mean2d.shape[0]
    return gather_rows(proj.mean2d, proj.conic, proj.mean2d.new_zeros(n), full_pay,
                       bins.gauss_idx)


def _blend_groups(proj, gdata, bins, opac_g, t0: int, grid_x: int, bg, chunk: int):
    """This rank's tiles of G groups (opac_g [G, N], the gathered splats'
    opacities per group) through the group entry of K5 at tile offset t0.
    -> tiles [G, tl, 256, C + 1]: the image over bg, then alpha."""
    opac_g = torch.where(proj.valid[None, :], opac_g, 0.0).contiguous()
    accum, t_final = rk.blend_tiles_fwd_groups(gdata, bins.gauss_idx, opac_g, bins.counts,
                                               grid_x, chunk, t0)
    C = accum.shape[2] - 1  # the last channel is depth
    img = accum[:, :, :C, :].transpose(2, 3) + t_final[..., None] * bg
    return torch.cat([img, (1.0 - t_final)[..., None]], dim=-1)


@torch.no_grad()
def render_groups_sharded(mesh: Mesh, camera: Camera, means3d, cov3d, opac_g, payload, bg,
                          config: RasterizeConfig = RasterizeConfig()):
    """G groups of splats sharded over the mesh (means3d [n, 3], cov3d
    [n, 3, 3], opac_g [G, n] each group's masked opacities, payload [n, C]:
    this rank's rows), over bg [C] (the sharded rasterize_groups). -> (images
    [G, H, W, C], alphas [G, H, W], n_lost), the same on every rank."""
    camera = camera.to(means3d.device)
    proj, full_pay, bins, t0, grid_x, grid_y = _project_gather_bin(
        mesh, camera, means3d, cov3d, opac_g.max(dim=0).values, payload, config)
    opac_f = all_gather(opac_g.T.contiguous(), mesh).T  # [G, N]
    tiles = _blend_groups(proj, _block(proj, full_pay, bins), bins, opac_f, t0, grid_x, bg,
                          config.chunk)
    G, tl = tiles.shape[:2]
    T = grid_x * grid_y
    full = all_gather(tiles.transpose(0, 1), mesh)[:T].transpose(0, 1)  # [G, T, 256, C+1]
    out = _untile(full.reshape(G * T, TILE * TILE, -1), grid_x, grid_y, camera.height,
                  camera.width)
    return out[..., :-1], out[..., -1], bins.n_dropped + bins.n_truncated


def _cluster_opacities(mesh: Mesh, gs, cluster_ids, group_ids, better_vis: bool,
                       scale_limit: float):
    """[G, n] masked opacities of this rank's splats and each group's member
    count [G] over the whole mesh (render/__init__.py:render_clusters'
    keep: the alive members, with better_vis those below scale_limit on
    every axis)."""
    keep = (cluster_ids[None, :] == group_ids[:, None]) & gs.alive[None, :]
    if better_vis:
        keep = keep & torch.all(gs.scales < scale_limit, dim=-1)[None, :]
    counts = keep.sum(dim=-1)
    dist.all_reduce(counts, group=mesh.group)
    return torch.where(keep, gs.opacity[None, :], 0.0), counts


def make_sweep_fns(mesh: Mesh, config: RasterizeConfig, k1: int, k2: int,
                   max_masks: int) -> SimpleNamespace:
    """-> a namespace of the sharded sweep1, sweep2 and lang_view, in place of
    the single-device sweeps of construct_pseudo_labels and
    associate_language. Every rank calls each with its own shards of the
    state and assignments and the same view."""

    @torch.no_grad()
    def sweep1(gs, camera, sam_ids, bg):
        """One view's origin-feature render and its mask means. -> (pseudo
        features [H, W, 6], filtered mask ids [H, W])."""
        camera = camera.to(gs.device)
        feat = encoded_ins_feat(gs, None, origin_feat=True)
        cov = build_cov3d(gs.scales, gs.quats)
        img, *_ = render_sharded(mesh, camera, gs.means, cov, gs.opacity, feat,
                                 torch.cat([bg, bg]), config)
        return pseudo_mod.sweep1_math(img, sam_ids, max_masks)

    @torch.no_grad()
    def sweep2(gs, camera, pseudo_feat, pseudo_ids, cls_ids, bg):
        """Every root cluster of one view rendered alone and matched to the
        pseudo masks. -> (matched count [k1], occur [k1])."""
        camera = camera.to(gs.device)
        feat = encoded_ins_feat(gs, None, origin_feat=True)
        cov = build_cov3d(gs.scales, gs.quats)
        opac_g, counts = _cluster_opacities(
            mesh, gs, cls_ids, torch.arange(k1, device=gs.device), better_vis=True,
            scale_limit=COARSE_SCALE_LIMIT)
        imgs, alphas, _lost = render_groups_sharded(mesh, camera, gs.means, cov, opac_g,
                                                    feat, torch.cat([bg, bg]), config)
        valid = counts >= MIN_CLUSTER_POINTS
        occur = (alphas.flatten(1).max(dim=1).values > OCCUR_SIL_THRESHOLD) & valid
        return pseudo_mod.sweep2_math(imgs, alphas, occur, pseudo_feat, pseudo_ids,
                                      max_masks)

    @torch.no_grad()
    def lang_view(gs, leaf_ids, camera, pseudo_feat, pseudo_ids, occur_row, bg):
        """All k1 roots of one view: one sharded projection, one gather of the
        table and of the alive and leaf vectors, one dense binning; per root
        this rank blends its tiles for the root's k2 leaves and sums its own
        pixels' silhouette areas, feature sums and mask overlaps; one
        all-reduce of every root's sums, then the scores.
        -> ([k1 * k2] mask id, score, matched)."""
        camera = camera.to(gs.device)
        dev = gs.device
        feat = encoded_ins_feat(gs, None, origin_feat=True)
        cov = build_cov3d(gs.scales, gs.quats)
        pm, pm_valid = masku.masks_onehot(pseudo_ids, max_masks)
        p_mean = masku.mask_feature_mean(pseudo_feat, pm)
        pm_area = pm.flatten(1).sum(dim=1).to(torch.float32)  # [M]
        opac_alive = torch.where(gs.alive, gs.opacity, 0.0)
        proj, full_pay, bins, t0, grid_x, grid_y = _project_gather_bin(
            mesh, camera, gs.means, cov, opac_alive, feat, config)
        alive_f, leaf_f = all_gather(gs.alive, mesh), all_gather(leaf_ids, mesh)
        opac_f = torch.where(alive_f, all_gather(gs.opacity, mesh), 0.0)
        tl = bins.counts.shape[0]
        # this rank's pixels: each pseudo mask's [tl, 256, M], and the image's
        pm_own = _rows(_tile_sam_onehot(pseudo_ids, grid_x, grid_y, max_masks), t0, tl)
        inside = _rows(_tile_sam_onehot(torch.ones_like(pseudo_ids), grid_x, grid_y, 1),
                       t0, tl)[..., 0] > 0
        bg6 = torch.cat([bg, bg])
        gdata = _block(proj, full_pay, bins)
        sums, counts = [], []
        for root in range(k1):
            group_ids = root * k2 + torch.arange(k2, device=dev)
            keep = (leaf_f[None, :] == group_ids[:, None]) & alive_f[None, :]
            counts.append(keep.sum(dim=-1))
            tiles = _blend_groups(proj, gdata, bins, torch.where(keep, opac_f, 0.0), t0,
                                  grid_x, bg6, config.chunk)  # [k2, tl, 256, 7]
            sil = ((tiles[..., -1] > lang_mod.SIL_THRESHOLD) & inside).to(torch.float32)
            sums.append(torch.cat([
                torch.einsum("gtpc,gtp->gc", tiles[..., :-1], sil),  # feature sums
                sil.sum(dim=(1, 2))[:, None],  # silhouette areas
                torch.einsum("gtp,tpm->gm", sil, pm_own)], dim=-1))  # mask overlaps
        sums = torch.stack(sums)  # [k1, k2, 6 + 1 + M]
        dist.all_reduce(sums, group=mesh.group)
        res = []
        for root in range(k1):
            f, area, inter = sums[root, :, :6], sums[root, :, 6], sums[root, :, 7:]
            pred_mean = f / (area + 1e-6)[:, None]
            ious = inter / torch.clamp(pm_area[None, :] + area[:, None] - inter, min=1.0)
            valid = counts[root] >= lang_mod.MIN_LEAF_POINTS
            res.append(lang_mod.score_matches(pred_mean, ious, valid, pm_valid, p_mean,
                                              occur_row[root]))
        mid, sc, ok = zip(*res)
        return torch.cat(mid), torch.cat(sc), torch.cat(ok)

    return SimpleNamespace(sweep1=sweep1, sweep2=sweep2, lang_view=lang_view)
