"""Load trained models from saved artifacts (PLY + codebooks + lang npz).

Port of opengaussian_tpu/models/loading.py (reference render.py:47-57,
render_lerf_by_text.py:46-63).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opengaussian_tpu_torch.data.ply import load_gaussian_ply
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.gaussians import (
    GaussianState,
    round_capacity,
    state_from_numpy,
)
from opengaussian_tpu_torch.ops.kmeans import KMeansState
from opengaussian_tpu_torch.utils.codebook import load_codebook


def state_from_arrays(d: dict, capacity: int | None = None,
                      device="cuda") -> GaussianState:
    """Alive-only arrays (as load_gaussian_ply returns them) -> a state
    padded to `capacity` (default: the next multiple of 4096)."""
    n = d["means"].shape[0]
    cap = capacity or round_capacity(n)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quats = pad(d["quats"])
    quats[n:, 0] = 1.0
    alive = np.zeros(cap, bool)
    alive[:n] = True
    return state_from_numpy(dict(
        means=pad(d["means"]),
        sh_dc=pad(d["sh_dc"]),
        sh_rest=pad(d["sh_rest"]),
        log_scales=pad(d["log_scales"]),
        quats=quats,
        logit_opacity=pad(d["logit_opacity"], fill=-10.0),
        ins_feat=pad(d["ins_feat"]),
        alive=alive,
    ), device)


def find_iteration(model_path: str, iteration: int = -1) -> int:
    pc = os.path.join(model_path, "point_cloud")
    iters = sorted(
        int(d.split("_")[1]) for d in os.listdir(pc) if d.startswith("iteration_")
    )
    return iters[-1] if iteration == -1 else iteration


def load_model(model_path: str, iteration: int = -1, k1: int = 64, k2: int = 5,
               device="cuda"):
    """-> (GaussianState, KMeansState | None, iteration)."""
    dev = resolve_device(device)
    it = find_iteration(model_path, iteration)
    pc_dir = os.path.join(model_path, f"point_cloud/iteration_{it}")
    d = load_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"))
    state = state_from_arrays(d, device=dev)
    cap = state.capacity
    n = d["means"].shape[0]

    kms = None
    root_dir = os.path.join(pc_dir, "root_code_book")
    if os.path.exists(root_dir):
        centers, cls = load_codebook(root_dir)
        cls_full = np.zeros(cap, np.int32)
        cls_full[:n] = cls
        leaf_dir = os.path.join(pc_dir, "leaf_code_book")
        if os.path.exists(leaf_dir):
            leaf_centers, leaf_cls = load_codebook(leaf_dir)
            k2_eff = (leaf_centers.shape[0] - 1) // centers.shape[0]
        else:
            leaf_centers = np.zeros((centers.shape[0] * k2 + 1, 6), np.float32)
            leaf_cls = np.full(n, centers.shape[0] * k2, np.int64)
            k2_eff = k2
        leaf_full = np.full(cap, leaf_centers.shape[0] - 1, np.int32)
        leaf_full[:n] = leaf_cls
        kms = KMeansState(
            centers=torch.as_tensor(np.asarray(centers, np.float32), device=dev),
            cls_ids=torch.as_tensor(cls_full, device=dev),
            leaf_centers=torch.as_tensor(np.asarray(leaf_centers, np.float32),
                                         device=dev),
            leaf_cls_ids=torch.as_tensor(leaf_full, device=dev),
            leaf_sub_num=torch.full((centers.shape[0],), k2_eff,
                                    dtype=torch.int32, device=dev),
        )
    return state, kms, it


def load_cluster_lang(model_path: str) -> dict[str, np.ndarray]:
    """The arrays of stage 3's cluster_lang.npz (leaf_feat, leaf_score,
    occu_count, leaf_ind)."""
    z = np.load(os.path.join(model_path, "cluster_lang.npz"))
    return {k: z[k] for k in z.files}
