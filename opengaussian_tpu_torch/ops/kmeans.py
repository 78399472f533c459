"""Two-level k-means codebook state (port of opengaussian_tpu/ops/kmeans.py).

Only the container that model loading fills is ported so far; assignment,
quantization and the Lloyd iterations arrive with the feature stages.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KMeansState:
    centers: torch.Tensor  # [k1, 9] coarse centers
    cls_ids: torch.Tensor  # [N] int32 coarse assignment
    leaf_centers: torch.Tensor  # [k1*k2+1, 6]
    leaf_cls_ids: torch.Tensor  # [N] int32 fine assignment
    leaf_sub_num: torch.Tensor  # [k1] int32 active leaves per root
