"""KNN utilities for selection post-processing.

Port of opengaussian_tpu/ops/knn.py (reference gaussian_renderer/__init__.py:
293-309, scripts/render_by_click.py:174-189): for the ~10^2-10^4 points of
one selected cluster, drop the points whose mean squared distance to their
K = sqrt(n) nearest neighbours exceeds mean + std over the cluster. Host-side
scipy cKDTree: it runs in the interactive selection tools, not in training.
`selection_mask` applies it to the splats of the chosen leaves.
"""

from __future__ import annotations

import numpy as np


def knn_mean_dists(points: np.ndarray, k: int) -> np.ndarray:
    """[n] mean squared distance of each point to its k nearest neighbours
    (itself excluded)."""
    from scipy.spatial import cKDTree

    k = max(min(k, len(points) - 1), 1)
    d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
    return (d[:, 1:] ** 2).mean(axis=1)


def statistical_outlier_mask(points: np.ndarray, max_rounds: int = 1) -> np.ndarray:
    """[n] bool keep-mask. The reference decrements max_time but breaks out of
    its loop after one pass (gaussian_renderer/__init__.py:292-311), so one
    round is its effective behaviour."""
    keep = np.ones(len(points), bool)
    for _ in range(max_rounds):
        pts = points[keep]
        if len(pts) < 3:
            break
        k = int(max(np.sqrt(len(pts)), 1))
        md = knn_mean_dists(pts, k)
        ok = md < md.mean() + md.std()
        idx = np.flatnonzero(keep)
        keep[idx[~ok]] = False
    return keep


def selection_mask(leaf_ids: np.ndarray, alive: np.ndarray, means: np.ndarray,
                   leaves) -> tuple[np.ndarray, int]:
    """The alive splats of `leaves`, less the KNN outliers when at least 10
    were selected (reference gaussian_renderer/__init__.py:293-309).
    -> ([N] bool mask, the count before the KNN mask)."""
    member = np.isin(leaf_ids, leaves) & alive
    n_before = int(member.sum())
    pts = means[member]
    if len(pts) >= 10:
        keep = statistical_outlier_mask(pts)
        idxs = np.flatnonzero(member)
        member[idxs[~keep]] = False
    return member, n_before
