"""Pseudo-label construction, sweep 1 (port of
opengaussian_tpu/train/pseudo.py; reference train.py:659-954).

Sweep 1 renders the full-image instance features of every training view once
(origin features, no rescale), averages them inside each SAM mask, drops
high-variance masks (> 0.006) except dominant-size ones (pixel count > 0.8 x
the largest), and keeps the per-view pseudo feature image and filtered mask
ids. Stage 2.1 trains against those images. Sweep 2 (leaf mode) comes with
stage 2.2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.gaussians import GaussianState
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.render import render
from opengaussian_tpu_torch.utils import masks as masku

VAR_THRESHOLD = 0.006  # reference train.py:692
DOMINANT_FRAC = 0.8  # reference train.py:695


class PseudoLabels(NamedTuple):
    """Root mode's labels (sweep 2's per-view cluster occurrence comes with
    leaf mode)."""

    feat: torch.Tensor  # [V, H, W, 6] filtered pseudo features
    mask_ids: torch.Tensor  # [V, H, W] int32 filtered pseudo mask ids (0 invalid)


def pseudo_from_numpy(feat, mask_ids, device="cuda") -> PseudoLabels:
    """Root-mode PseudoLabels from numpy arrays, e.g. the JAX package's."""
    dev = resolve_device(device)
    return PseudoLabels(feat=torch.tensor(np.asarray(feat, np.float32), device=dev),
                        mask_ids=torch.tensor(np.asarray(mask_ids, np.int32), device=dev))


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


@torch.no_grad()
def _sweep1_view(gs: GaussianState, camera, sam_ids, bg, max_masks: int,
                 config: RasterizeConfig):
    out = render(camera, gs, bg, 3, config, render_color=False, render_feat_map=True,
                 origin_feat=True, rescale_factor=1.0)
    return sweep1_math(out.ins_feat, sam_ids, max_masks)


def construct_pseudo_labels(gs: GaussianState, cameras, sam_ids: torch.Tensor, bg,
                            max_masks: int, config: RasterizeConfig,
                            mode: str = "root") -> PseudoLabels:
    """Sweep 1 over `cameras` (sorted by image name, as reference
    train.py:673) with their decoded SAM ids [V, H, W]."""
    if mode != "root":
        raise NotImplementedError(
            f"pseudo labels in {mode!r} mode (sweep 2) arrive with the port's "
            "stage-2.2 slice")
    feats, ids = zip(*(_sweep1_view(gs, cam, sam_ids[i], bg, max_masks, config)
                       for i, cam in enumerate(cameras)))
    return PseudoLabels(feat=torch.stack(feats), mask_ids=torch.stack(ids))
