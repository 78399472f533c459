"""Gaussian parameter store (port of opengaussian_tpu/models/gaussians.py,
the part the render path needs).

A frozen dataclass of tensors padded to a capacity that is a multiple of
4096, with an `alive` mask; padded slots have `logit_opacity = -10`,
identity quaternions and `alive = False`, and render as fully transparent.
Densification, pruning and the optimizer arrive with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.ops.sh import rgb_to_sh

PARAM_FIELDS = (
    "means",
    "sh_dc",
    "sh_rest",
    "log_scales",
    "quats",
    "logit_opacity",
    "ins_feat",
)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """All tensors are [N_cap, ...]; slots with alive=False are padding."""

    means: torch.Tensor  # [N,3]
    sh_dc: torch.Tensor  # [N,1,3]
    sh_rest: torch.Tensor  # [N,(K-1),3]
    log_scales: torch.Tensor  # [N,3]
    quats: torch.Tensor  # [N,4] (w,x,y,z), unnormalized
    logit_opacity: torch.Tensor  # [N]
    ins_feat: torch.Tensor  # [N,6] continuous instance features
    alive: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacity(self) -> torch.Tensor:
        # dead slots render as fully transparent
        return torch.where(self.alive, torch.sigmoid(self.logit_opacity), 0.0)

    @property
    def sh(self) -> torch.Tensor:
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)  # [N,K,3]

    def normalized_ins_feat(self, quantized: torch.Tensor | None = None):
        """L2-normalized instance feature (all-zero rows stay zero); pass
        quantized features to mimic the reference's get_ins_feat(origin=False)."""
        f = self.ins_feat if quantized is None else quantized
        sq = torch.sum(f * f, dim=-1, keepdim=True)
        n = torch.sqrt(torch.where(sq > 0, sq, 1.0))
        return torch.where(sq > 0, f / n, 0.0)

    def params(self) -> dict:
        return {k: getattr(self, k) for k in PARAM_FIELDS}


def round_capacity(n: int, multiple: int = 4096) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def state_from_numpy(d: dict, device="cuda") -> GaussianState:
    """A GaussianState from numpy arrays of every field (PARAM_FIELDS and
    `alive`), e.g. the JAX package's GaussianState leaves, already padded."""
    dev = resolve_device(device)
    fields = {k: torch.as_tensor(np.asarray(d[k], np.float32), device=dev)
              for k in PARAM_FIELDS}
    alive = torch.as_tensor(np.asarray(d["alive"], bool), device=dev)
    return GaussianState(alive=alive, **fields)


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest neighbors (scale init), on
    scipy's cKDTree as the reference fork's CPU replacement of distCUDA2."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
    return (d[:, 1:] ** 2).mean(axis=1)


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int = 3,
    seed: int = 0,
    capacity: int | None = None,
    device="cuda",
) -> GaussianState:
    """Initialize from an SfM point cloud (reference
    scene/gaussian_model.py:181-209): scales from sqrt of the KNN mean
    squared distance, identity rotations, opacity 0.1, ins_feat ~ U[0,1).
    The draws come from numpy's generator with `seed`, as in the JAX
    package, so both packages start from the same features."""
    n = points.shape[0]
    cap = capacity or round_capacity(n)
    k = (sh_degree + 1) ** 2
    rng = np.random.default_rng(seed)

    dist2 = np.maximum(knn_mean_sq_dist(points), 1e-7)
    log_scales = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, dtype=np.float32)
        out[:n] = x
        return out

    quats = pad(np.tile(np.float32([1, 0, 0, 0]), (n, 1)))
    quats[n:, 0] = 1.0
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    logit = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))
    return state_from_numpy(dict(
        means=pad(points.astype(np.float32)),
        sh_dc=pad(rgb_to_sh(colors.astype(np.float32))[:, None, :]),
        sh_rest=pad(np.zeros((n, k - 1, 3), np.float32)),
        log_scales=pad(log_scales.astype(np.float32)),
        quats=quats,
        logit_opacity=pad(np.full((n,), logit, np.float32), fill=-10.0),
        ins_feat=pad(rng.random((n, 6), np.float32)),
        alive=alive,
    ), device)
