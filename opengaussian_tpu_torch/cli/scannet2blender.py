"""ScanNet -> Blender-format transforms_train.json.

Port of opengaussian_tpu/cli/scannet2blender.py (the reference's
scripts/scannet2blender.py): reads per-frame 4x4 camera-to-world poses
(pose/*.txt) and the color intrinsics (intrinsic/intrinsic_color.txt,
defaults 1296x968), converts COLMAP-style axes to the OpenGL convention the
Blender reader expects (the reader flips them back), and writes frames with
per-frame K matrices. Host numpy only:

    python -m opengaussian_tpu_torch.cli.scannet2blender --scan_dir <scan>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DEFAULT_W, DEFAULT_H = 1296, 968


def convert(scan_dir: str, out_path: str | None = None, image_dir: str = "color"):
    pose_dir = os.path.join(scan_dir, "pose")
    intr_path = os.path.join(scan_dir, "intrinsic", "intrinsic_color.txt")
    if os.path.exists(intr_path):
        K4 = np.loadtxt(intr_path)
        K = K4[:3, :3]
    else:
        K = np.array([[1170.19, 0, DEFAULT_W / 2], [0, 1170.19, DEFAULT_H / 2], [0, 0, 1.0]])

    frames = []
    for fn in sorted(os.listdir(pose_dir), key=lambda s: int(os.path.splitext(s)[0])):
        c2w = np.loadtxt(os.path.join(pose_dir, fn))
        if not np.isfinite(c2w).all():
            continue  # ScanNet marks untracked frames with -inf poses
        # COLMAP (y down, z forward) -> OpenGL (y up, z back); the Blender
        # reader applies the inverse flip (dataset.py read_blender_scene)
        c2w = c2w.copy()
        c2w[:3, 1:3] *= -1
        stem = os.path.splitext(fn)[0]
        frames.append(
            dict(
                file_path=f"{image_dir}/{stem}",
                transform_matrix=c2w.tolist(),
                K=K.tolist(),
            )
        )
    out = dict(w=DEFAULT_W, h=DEFAULT_H, fl_x=float(K[0, 0]), fl_y=float(K[1, 1]),
               cx=float(K[0, 2]), cy=float(K[1, 2]), frames=frames)
    out_path = out_path or os.path.join(scan_dir, "transforms_train.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {len(frames)} frames to {out_path}")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scan_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--image_dir", default="color")
    args = p.parse_args(argv)
    convert(args.scan_dir, args.out, args.image_dir)


if __name__ == "__main__":
    main()
