"""Pseudo-label construction sweeps (port of opengaussian_tpu/train/pseudo.py;
reference train.py:659-954).

Sweep 1 (every mode) renders the full-image instance features of every
training view once (origin features, no rescale), averages them inside each
SAM mask, drops high-variance masks (> 0.006) except dominant-size ones
(pixel count > 0.8 x the largest), and keeps the per-view pseudo feature
image and filtered mask ids. Stage 2.1 trains against those images.

Sweep 2 (leaf mode, at stage-2.2 entry) renders every coarse cluster of
every view alone, matches each to the view's pseudo masks by IoU > 0.2
(over the mask's area) and feature-distance gates (L1 < 0.9, L2 < 0.5, the
10 smallest L1), and derives each root's object count (+1, at most k2: the
root's active leaf count) and the per-view cluster visibility that gates
the stage-2.2 update. Sweep 3 (stage 3) is train/lang.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.gaussians import GaussianState
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.render import render, render_clusters
from opengaussian_tpu_torch.utils import masks as masku

VAR_THRESHOLD = 0.006  # reference train.py:692
DOMINANT_FRAC = 0.8  # reference train.py:695
IOU_GATE = 0.2  # reference train.py:778
L1_GATE = 0.9  # reference train.py:792
L2_GATE = 0.5
MAX_MATCHED = 10  # reference train.py:793


class PseudoLabels(NamedTuple):
    feat: torch.Tensor  # [V, H, W, 6] filtered pseudo features
    mask_ids: torch.Tensor  # [V, H, W] int32 filtered pseudo mask ids (0 invalid)
    cluster_occur: torch.Tensor | None = None  # [V, k1] bool (leaf mode)
    leaf_sub_num: torch.Tensor | None = None  # [k1] int32 active leaves per root


def pseudo_from_numpy(feat, mask_ids, device="cuda", cluster_occur=None,
                      leaf_sub_num=None) -> PseudoLabels:
    """PseudoLabels from numpy arrays, e.g. the JAX package's."""
    dev = resolve_device(device)
    t = lambda x, dt: None if x is None else torch.tensor(np.asarray(x, dt), device=dev)  # noqa: E731
    return PseudoLabels(feat=t(feat, np.float32), mask_ids=t(mask_ids, np.int32),
                        cluster_occur=t(cluster_occur, bool),
                        leaf_sub_num=t(leaf_sub_num, np.int32))


def sweep1_math(feat, sam_ids, max_masks: int):
    """Mask means and the variance filter of one view: feat [H, W, 6], SAM
    ids [H, W] -> (pseudo feature image [H, W, 6], filtered mask ids [H, W]
    int32)."""
    masks, valid = masku.masks_onehot(sam_ids, max_masks)
    mean, var, counts = masku.mask_feature_mean(feat, masks, return_var=True)
    drop = (var > VAR_THRESHOLD) & valid
    dominant = counts > counts.max() * DOMINANT_FRAC
    keep = valid & ~(drop & ~dominant)
    mean_kept = torch.where(keep[:, None], mean, 0.0)
    # image-level pseudo features: gather by mask id (0 -> zeros row)
    table = torch.cat([mean.new_zeros((1, mean.shape[1])), mean_kept], dim=0)
    ids = sam_ids.long()
    pseudo = table[torch.clamp(ids, 0, max_masks)]
    filt = torch.where(keep[torch.clamp(ids - 1, 0, max_masks - 1)] & (ids > 0), ids, 0)
    return pseudo, filt.to(torch.int32)


def sweep2_math(cluster_imgs, cluster_sils, cluster_occur, pseudo_feat, pseudo_ids,
                max_masks: int):
    """Matching of one view's cluster renders (cluster_imgs [k1, H, W, 6],
    cluster_sils [k1, H, W], cluster_occur [k1]) to its pseudo masks.
    -> (matched count [k1] int32, occur [k1] bool)."""
    pm, pm_valid = masku.masks_onehot(pseudo_ids, max_masks)  # [M, H, W]
    p_mean = masku.mask_feature_mean(pseudo_feat, pm)  # [M, 6]
    counts, occur = [], []
    for img, sil_raw, ok in zip(cluster_imgs, cluster_sils, cluster_occur):
        sil = sil_raw > 0.9
        ious = masku.calculate_iou(pm, sil[None], base="former")  # [M]
        inter = (ious > IOU_GATE) & pm_valid
        c_mean = masku.mask_feature_mean(img, pm, image_mask=sil)  # [M, 6]
        l1 = (p_mean - c_mean).abs().sum(-1)
        l2 = torch.sqrt(torch.clamp(((p_mean - c_mean) ** 2).sum(-1), min=0.0))
        good = inter & (l1 < L1_GATE) & (l2 < L2_GATE)
        n_good = good.sum()
        # at most 10, by the smallest l1 (the reference keeps the top 10)
        order = torch.argsort(torch.where(good, l1, torch.inf), stable=True)
        l1_rank = torch.argsort(order, stable=True)
        good = good & (l1_rank < MAX_MATCHED)
        any_match = good.any() & ok
        counts.append(torch.where(any_match, torch.clamp(n_good, max=MAX_MATCHED), 0))
        occur.append(any_match)
    return torch.stack(counts).to(torch.int32), torch.stack(occur)


@torch.no_grad()
def _sweep1_view(gs: GaussianState, camera, sam_ids, bg, max_masks: int,
                 config: RasterizeConfig):
    out = render(camera, gs, bg, 3, config, render_color=False, render_feat_map=True,
                 origin_feat=True, rescale_factor=1.0)
    return sweep1_math(out.ins_feat, sam_ids, max_masks)


@torch.no_grad()
def _sweep2_view(gs: GaussianState, camera, pseudo_feat, pseudo_ids, cls_ids, bg,
                 max_masks: int, k1: int, config: RasterizeConfig):
    """Every root cluster of one view rendered alone (origin features, the
    better_vis scale cull at 0.5, valid from 100 splats) and matched.
    -> (matched count [k1], occur [k1])."""
    out = render_clusters(camera, gs, bg, cls_ids, torch.arange(k1, device=gs.device),
                          config, origin_feat=True, better_vis=True, scale_limit=0.5,
                          min_points=100)
    return sweep2_math(out.cluster_imgs, out.cluster_silhouettes, out.cluster_occur,
                       pseudo_feat, pseudo_ids, max_masks)


def _view_on(x, i: int, dev: torch.device) -> torch.Tensor:
    """View i of a [V, ...] stack on `dev`: a device tensor, a host tensor
    (copied) or a data/lazy.LazyStack (decoded, then copied)."""
    x = x[i]
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(x)
    return x.to(dev, non_blocking=True)


def _host_stack(xs) -> torch.Tensor:
    """Stack device tensors in host memory, pinned when they come from a
    GPU."""
    out = torch.stack([x.cpu() for x in xs])
    return out.pin_memory() if xs[0].device.type == "cuda" else out


def construct_pseudo_labels(gs: GaussianState, cameras, sam_ids, bg,
                            max_masks: int, config: RasterizeConfig,
                            mode: str = "root", cls_ids: torch.Tensor | None = None,
                            k1: int = 64, k2: int = 5,
                            to_host: bool = False) -> PseudoLabels:
    """Sweep 1 over `cameras` (sorted by image name, as reference
    train.py:673) with their decoded SAM ids [V, H, W] (on the device, in
    host memory or lazy); in leaf mode also sweep 2 with the root assignment
    cls_ids [N], which gives each view's cluster_occur [V, k1] and
    leaf_sub_num = min(max matched count + 1, k2) (reference train.py:835).
    to_host=True (the save_memory mode) keeps the per-view results, the
    pseudo-feature images above all ([V, H, W, 6] f32, the largest buffer
    of training), in host memory; the trainer copies one view per step."""
    if mode not in ("root", "leaf"):
        raise ValueError(f"mode must be 'root' or 'leaf', got {mode!r}")
    stack = _host_stack if to_host else torch.stack
    feats, ids = zip(*(_sweep1_view(gs, cam, _view_on(sam_ids, i, gs.device), bg,
                                    max_masks, config)
                       for i, cam in enumerate(cameras)))
    feat, mask_ids = stack(feats), stack(ids)
    if mode == "root":
        return PseudoLabels(feat=feat, mask_ids=mask_ids)
    if cls_ids is None:
        raise ValueError("leaf mode needs the root assignment cls_ids")
    counts = torch.ones((k1,), dtype=torch.int32, device=gs.device)
    occ = []
    for i, cam in enumerate(cameras):
        c, o = _sweep2_view(gs, cam, _view_on(feat, i, gs.device),
                            _view_on(mask_ids, i, gs.device), cls_ids, bg, max_masks, k1,
                            config)
        counts = torch.maximum(counts, c)
        occ.append(o)
    return PseudoLabels(feat=feat, mask_ids=mask_ids, cluster_occur=stack(occ),
                        leaf_sub_num=torch.clamp(counts + 1, max=k2))
