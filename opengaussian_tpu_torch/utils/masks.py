"""SAM mask decoding (port of opengaussian_tpu/utils/masks.py, the part the
render CLI needs)."""

from __future__ import annotations

import numpy as np


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
