"""Visualize per-point instance features.

Port of opengaussian_tpu/cli/vis_pts_feat.py (the reference's
scripts/vis_opengs_pts_feat.py, an open3d viewer): colors each Gaussian by
its first three normalized instance-feature channels. Headless-friendly:
writes a colored PLY (feature -> RGB) that any point-cloud viewer (open3d,
meshlab, rerun) can open; with --use_open3d and a display it opens the
interactive window like the reference. Host numpy only:

    python -m opengaussian_tpu_torch.cli.vis_pts_feat --ply <point_cloud.ply>
"""

from __future__ import annotations

import argparse

import numpy as np


def feature_colors(ins_feat: np.ndarray) -> np.ndarray:
    f = ins_feat / (np.linalg.norm(ins_feat, axis=1, keepdims=True) + 1e-12)
    return np.clip((f[:, :3] + 1) / 2, 0, 1)


def main(argv=None):
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply, store_point_cloud

    p = argparse.ArgumentParser()
    p.add_argument("--ply", required=True, help="point_cloud.ply from training")
    p.add_argument("--out", default="pts_feat_vis.ply")
    p.add_argument("--use_open3d", action="store_true")
    args = p.parse_args(argv)

    d = load_gaussian_ply(args.ply)
    cols = feature_colors(d["ins_feat"])
    if args.use_open3d:
        import open3d as o3d  # optional dependency, like the reference

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(d["means"].astype(np.float64))
        pcd.colors = o3d.utility.Vector3dVector(cols.astype(np.float64))
        o3d.visualization.draw_geometries([pcd])
    else:
        store_point_cloud(args.out, d["means"], (cols * 255).astype(np.uint8))
        print(f"wrote {args.out} ({len(cols)} points)")


if __name__ == "__main__":
    main()
