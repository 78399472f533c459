"""Stage 3: association of 2D CLIP language features with the 3D leaf clusters
(port of opengaussian_tpu/train/lang.py; reference train.py:842-954).

For every training view and coarse root, render the root's k2 leaf clusters,
score each leaf against every pseudo mask of the view with IoU x (1 - L1 of
the feature means) (Eq. (5) of the paper), keep the best mask above 0.2,
and average the matched masks' CLIP features per leaf across views. Writes
the JAX package's `cluster_lang.npz`: leaf_feat [k1 * k2, 512], leaf_score,
occu_count and leaf_ind (one leaf id per alive splat).

Per view, one projection of the alive splats and one depth rank serve all
k1 roots. With the stream layout each root's k2 leaves render in one
`render_clusters_partition` (one K1 launch per root), on the card and on
the CPU alike; with the dense layout they render one after the other
through `render_clusters`.
"""

from __future__ import annotations

import numpy as np
import torch

from opengaussian_tpu_torch.ops.binning import depth_rank
from opengaussian_tpu_torch.ops.projection import build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.render import render_clusters, render_clusters_partition
from opengaussian_tpu_torch.utils import masks as masku

MATCH_THRESHOLD = 0.2  # reference train.py:887
SIL_THRESHOLD = 0.8
MIN_LEAF_POINTS = 10  # reference train.py:312-313


def score_leaves(cluster_imgs, cluster_sils, cluster_valid, pm, pm_valid, p_mean,
                 root_visible):
    """One root's k2 leaf renders (cluster_imgs [k2, H, W, 6], cluster_sils
    [k2, H, W], cluster_valid [k2]) against the view's pseudo masks pm
    [M, H, W] (valid pm_valid [M], feature means p_mean [M, 6]).
    -> (mask id [k2] int32, 1-based, 0 if unmatched; score [k2]; matched
    [k2] bool)."""
    sils = cluster_sils > SIL_THRESHOLD
    pred_mean = masku.pair_mask_feature_mean(cluster_imgs, sils)  # [k2, 6]
    ious = masku.calculate_iou(pm[None], sils[:, None])  # [k2, M]
    l1 = (pred_mean[:, None, :] - p_mean[None, :, :]).abs().sum(-1)  # [k2, M]
    scores = torch.where(pm_valid[None, :], ious * (1.0 - l1), -torch.inf)
    max_ind = torch.argmax(scores, dim=-1)  # the first best mask, as jnp.argmax
    max_score = torch.gather(scores, 1, max_ind[:, None])[:, 0]
    matched = (max_score > MATCH_THRESHOLD) & cluster_valid & root_visible
    mask_id = torch.where(matched, max_ind + 1, 0)
    score = torch.where(matched, max_score, 0.0)
    return mask_id.to(torch.int32), score, matched


@torch.no_grad()
def _associate_view(gs, leaf_ids, camera, pseudo_feat, pseudo_ids, occur_row, bg,
                    k1: int, k2: int, max_masks: int, config: RasterizeConfig):
    """Every root of one view. -> (mask id [k1 * k2], score [k1 * k2],
    matched [k1 * k2])."""
    camera = camera.to(gs.device)
    pm, pm_valid = masku.masks_onehot(pseudo_ids, max_masks)  # [M, H, W]
    p_mean = masku.mask_feature_mean(pseudo_feat, pm)  # [M, 6]
    partition = config.pallas_input == "stream"
    if partition:
        opac_all = torch.where(gs.alive, gs.opacity, 0.0)
        proj = project(gs.means, build_cov3d(gs.scales, gs.quats), camera,
                       opacities=opac_all if config.tight_radius else None)
        rank = depth_rank(proj.depth)
    res = []
    for root in range(k1):
        group_ids = root * k2 + torch.arange(k2, device=gs.device)
        if partition:
            out = render_clusters_partition(camera, gs, bg, leaf_ids, group_ids, config,
                                            origin_feat=True, min_points=MIN_LEAF_POINTS,
                                            proj=proj, rank=rank)
        else:
            out = render_clusters(camera, gs, bg, leaf_ids, group_ids, config,
                                  origin_feat=True, min_points=MIN_LEAF_POINTS)
        res.append(score_leaves(out.cluster_imgs, out.cluster_silhouettes,
                                out.cluster_valid, pm, pm_valid, p_mean, occur_row[root]))
    mid, sc, ok = zip(*res)
    return torch.cat(mid), torch.cat(sc), torch.cat(ok)


def associate_language(state, kms, bundle, pseudo, clip_tables: list, bg, k1: int,
                       k2: int, config: RasterizeConfig, out_path: str | None = None) -> dict:
    """The stage-3 sweep over every view of `bundle` (a ViewBundle) with its
    PseudoLabels (feat, mask_ids and, in leaf mode, cluster_occur) and the
    per-view CLIP tables (clip_tables_from_views; None for a view without
    one). -> {leaf_feat, leaf_score, occu_count, leaf_ind} as numpy arrays,
    also saved to out_path (.npz) when given."""
    V = bundle.num_views
    match_id = np.zeros((k1 * k2, V), np.int64)
    match_score = np.zeros((k1 * k2, V), np.float32)
    match_ok = np.zeros((k1 * k2, V), bool)
    dev = state.device
    for v in range(V):
        occur_row = (pseudo.cluster_occur[v].to(dev) if pseudo.cluster_occur is not None
                     else torch.ones((k1,), dtype=torch.bool, device=dev))
        # the pseudo labels are in host memory under save_memory
        mid, sc, ok = _associate_view(state, kms.leaf_cls_ids, bundle.camera(v),
                                      pseudo.feat[v].to(dev, non_blocking=True),
                                      pseudo.mask_ids[v].to(dev, non_blocking=True),
                                      occur_row, bg, k1, k2, bundle.max_masks, config)
        match_id[:, v] = mid.cpu().numpy()
        match_score[:, v] = sc.cpu().numpy()
        match_ok[:, v] = ok.cpu().numpy()

    occu_count = match_ok.sum(axis=1).astype(np.float32)  # [k1 * k2]
    leaf_score = match_score.sum(axis=1) / (occu_count + 1e-6)
    feat_sum = np.zeros((k1 * k2, 512), np.float32)
    for v in range(V):
        tab = clip_tables[v]
        if tab is None:
            continue
        # row 0 = zero feature for unmatched leaves (reference train.py:930-938)
        tab0 = np.concatenate([np.zeros((1, tab.shape[1]), np.float32), tab], axis=0)
        feat_sum += tab0[np.clip(match_id[:, v], 0, tab0.shape[0] - 1)]
    leaf_feat = feat_sum / (occu_count + 1e-4)[:, None]
    result = dict(leaf_feat=leaf_feat, leaf_score=leaf_score, occu_count=occu_count,
                  leaf_ind=kms.leaf_cls_ids.cpu().numpy()[state.alive.cpu().numpy()])
    if out_path:
        np.savez(out_path, **result)
    return result


def clip_tables_from_views(views, sam_level: int) -> list:
    """Per-view CLIP feature tables [num_mask, 512] sliced to the training
    SAM level (reference train.py:922-929, utils/opengs_utlis.py:173-180);
    None for a view without a table or SAM sidecar."""
    out = []
    for v in views:
        if v.clip_feats is None or v.sam_mask is None:
            out.append(None)
            continue
        lo, hi = masku.clip_feat_slice(np.asarray(v.sam_mask), sam_level)
        out.append(np.asarray(v.clip_feats[lo:hi], np.float32))
    return out
