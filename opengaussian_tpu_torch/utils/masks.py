"""SAM mask decoding and per-mask feature statistics (port of
opengaussian_tpu/utils/masks.py; reference utils/opengs_utlis.py:125-283).

Masks live as a dense id map [H, W] plus a max_masks bound, as in the JAX
package, and the per-mask means and variances are one [M, HW] x [HW, C]
product in float32 (the default full-precision matmul: no TF32).
"""

from __future__ import annotations

import numpy as np
import torch


def decode_sam_level(packed: np.ndarray, level: int) -> np.ndarray:
    """Packed 4-level SAM mask [4, H, W] -> mask ids [H, W] at `level`.

    Semantics of reference utils/opengs_utlis.py:134-146: level>0 ids are
    offset by (max id of previous level + 1); anything negative becomes the
    invalid id 0; valid masks are 1..num_mask.
    """
    mask_id = packed[level].astype(np.int64)
    if level > 0:
        mask_id = mask_id - (packed[level - 1].max() + 1)
    mask_id = np.clip(mask_id, -1, None) + 1
    return mask_id


def masks_onehot(mask_id: torch.Tensor, max_masks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """mask ids [H, W] (0 invalid) -> bool [M, H, W] for ids 1..M plus a
    validity vector [M] (True where the mask has any pixel)."""
    ids = torch.arange(1, max_masks + 1, dtype=mask_id.dtype, device=mask_id.device)
    onehot = mask_id[None, :, :] == ids[:, None, None]
    return onehot, onehot.flatten(1).any(dim=1)


def mask_feature_mean(feat_map: torch.Tensor, masks: torch.Tensor,
                      image_mask: torch.Tensor | None = None, return_var: bool = False):
    """Mean (and optionally variance) of feat_map within each mask.

    feat_map [H, W, C], masks [M, H, W] bool -> mean [M, C]; with return_var
    -> (mean, per-mask variance averaged over channels [M], pixel counts [M])
    (reference utils/opengs_utlis.py:240-283, without the chunking)."""
    H, W, C = feat_map.shape
    m = masks.reshape(masks.shape[0], -1).to(torch.float32)  # [M, HW]
    if image_mask is not None:
        m = m * image_mask.reshape(1, -1).to(torch.float32)
    f = feat_map.reshape(-1, C)  # [HW, C]
    counts = torch.clamp(m.sum(dim=1), min=1.0)  # [M]
    mean = (m @ f) / counts[:, None]
    if not return_var:
        return mean
    sq = (m @ (f * f)) / counts[:, None]
    return mean, (sq - mean * mean).mean(dim=1), counts


def calculate_iou(mask1: torch.Tensor, mask2: torch.Tensor, base: str = "union"):
    """IoU between two boolean mask stacks, broadcast over leading dims.
    base='former'/'later' divides by one side's area instead of the union
    (reference utils/opengs_utlis.py:90-123)."""
    inter = (mask1 & mask2).sum(dim=(-2, -1)).to(torch.float32)
    if base == "former":
        denom = mask1.sum(dim=(-2, -1)).to(torch.float32)
    elif base == "later":
        denom = mask2.sum(dim=(-2, -1)).to(torch.float32)
    else:
        denom = (mask1 | mask2).sum(dim=(-2, -1)).to(torch.float32)
    return inter / torch.clamp(denom, min=1.0)
