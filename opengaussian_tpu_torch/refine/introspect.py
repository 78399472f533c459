"""Stage-by-stage introspection for the SAM refiner (the port's own copy of
opengaussian_tpu/refine/introspect.py; numpy, PIL and, where installed,
rerun).

Counterpart of the reference's rerun streaming (the checked-in blueprint
`sam_refinement_multistage.rbl` + `utils/sam_refinement_utils.py:716-724,
1136-1146` logs the world frame, the gaussian point cloud, per-camera poses
and per-stage mask images). This collector receives each stage's
intermediates from `refine_sam_masks(trace=...)` and

  * always writes a headless artifact set under `<out>/refine_trace/`:
      depth_<v>.png              stage-0 expected-depth maps
      stage1_sync.npz            anchors, per-(view, anchor) winning local
                                 ids, the local->global table
      dominant_<v>.png           stage-2 per-pixel winning-id weight (max
                                 over ids, pre-threshold)
      refined_<v>.png            final colorized global ids
      summary.json               per-stage scalar counters
  * additionally streams to rerun when the `rerun` SDK is importable
    (optional dependency, like SURVEY §7.2 M7 treats it): world frame,
    point cloud, camera poses, and the same per-stage images.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _try_rerun():
    try:
        import rerun as rr  # optional; not in the base image

        return rr
    except ImportError:
        return None


def _save_png(path: str, arr: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(np.nan_to_num(a), 0.0, 1.0) * 255).astype(np.uint8)
    Image.fromarray(a).save(path)


def _palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    pal = rng.integers(40, 255, (max(n, 1) + 2, 3)).astype(np.uint8)
    pal[0] = (30, 30, 30)  # void / id 0
    return pal


class RefinerTrace:
    """Collects refiner stage intermediates; write() emits the artifacts."""

    def __init__(self, out_dir: str, rerun_app: str = "opengs_refine"):
        self.out = os.path.join(out_dir, "refine_trace")
        self.depths: list[np.ndarray] = []
        self.stage1: dict = {}
        self.dominant: list[np.ndarray] = []
        self.summary: dict = {}
        self.rr = _try_rerun()
        if self.rr is not None:
            self.rr.init(rerun_app, spawn=False)
            save_path = os.path.join(self.out, "refine_trace.rrd")
            os.makedirs(self.out, exist_ok=True)
            self.rr.save(save_path)
            self.rr.log(
                "world_frame",
                self.rr.Arrows3D(
                    vectors=[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                    colors=[[255, 0, 0], [0, 255, 0], [0, 0, 255]],
                ),
            )

    # -- stage hooks (called by refine_sam_masks) --

    def log_scene(self, means: np.ndarray, alive: np.ndarray):
        pts = np.asarray(means)[np.asarray(alive)]
        self.summary["n_splats"] = int(len(pts))
        if self.rr is not None:
            self.rr.log("gaussian_pointcloud",
                        self.rr.Points3D(pts, radii=0.005, colors=[0, 255, 0]))

    def log_depth(self, v: int, depth: np.ndarray, visible: np.ndarray):
        d = np.asarray(depth)
        self.depths.append(d)
        self.summary.setdefault("visible_per_view", []).append(
            int(np.asarray(visible).sum())
        )
        if self.rr is not None:
            self.rr.log(f"gs/camera_{v}/depth", self.rr.DepthImage(d))

    def log_stage1(self, anchors: np.ndarray, win_lid: np.ndarray,
                   local2global: np.ndarray, n_gids: int):
        self.stage1 = dict(
            anchors=np.asarray(anchors),
            win_lid=np.asarray(win_lid),  # [V, A] 0 = no winner
            local2global=np.asarray(local2global),  # [V, max_ids+1]
            n_gids=int(n_gids),
        )
        self.summary["n_anchors"] = int(len(anchors))
        self.summary["n_global_ids"] = int(n_gids)

    def log_stage2(self, v: int, dom: np.ndarray, splat_gid: np.ndarray,
                   weights: np.ndarray):
        w = np.asarray(weights)
        self.dominant.append(w.max(axis=-1))
        self.summary.setdefault("contributing_per_view", []).append(
            int(((np.asarray(dom) == np.asarray(splat_gid))
                 & (np.asarray(splat_gid) > 0)).sum())
        )
        if self.rr is not None:
            self.rr.log(f"gs/camera_{v}/expansion_weight",
                        self.rr.Image(w.max(axis=-1)))

    # -- emission --

    def write(self, refined: np.ndarray):
        os.makedirs(self.out, exist_ok=True)
        for v, d in enumerate(self.depths):
            mx = d.max() or 1.0
            _save_png(os.path.join(self.out, f"depth_{v}.png"), d / mx)
        if self.stage1:
            np.savez(os.path.join(self.out, "stage1_sync.npz"), **self.stage1)
        for v, w in enumerate(self.dominant):
            mx = w.max() or 1.0
            _save_png(os.path.join(self.out, f"dominant_{v}.png"), w / mx)
        pal = _palette(int(refined.max()))
        for v in range(refined.shape[0]):
            ids = np.maximum(np.asarray(refined[v]), 0)
            _save_png(os.path.join(self.out, f"refined_{v}.png"), pal[ids])
            if self.rr is not None:
                self.rr.log(f"gs/camera_{v}/refined",
                            self.rr.SegmentationImage(ids))
        with open(os.path.join(self.out, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=1)
        return self.out
