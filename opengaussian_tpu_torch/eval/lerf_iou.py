"""LeRF-OVS mask IoU evaluation.

Port of opengaussian_tpu/eval/lerf_iou.py (reference
scripts/compute_lerf_iou.py): compares the predicted object masks (the
renders_cluster_silhouette PNGs of cli/render_by_text.py) against the
LangSplat-annotated GT object masks on the per-scene eval frames; reports
mIoU, Acc@0.25, Acc@0.5. Missing predictions count as IoU 0, like the
reference. Host numpy only:

    python -m opengaussian_tpu_torch.eval.lerf_iou --scene_name teatime \
        --gt_base <label dir> --pred_base <model>/text2obj/ours_<it>/renders_cluster_silhouette
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

from opengaussian_tpu_torch.cli.render_by_text import SCENE_EVAL_FRAMES


def load_binary(path: str, to_gray: bool = False, threshold: int = 10) -> np.ndarray:
    img = Image.open(path)
    if to_gray:
        img = img.convert("L")
    return (np.asarray(img) > threshold).astype(int)


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    union = np.logical_or(a, b).sum()
    return float(np.logical_and(a, b).sum() / union) if union else 0.0


def evaluate(gt_base: str, pred_base: str, scene_name: str) -> dict:
    frames = SCENE_EVAL_FRAMES[scene_name]
    ious = []
    detail = {}
    for frame in frames:
        gt_dir = os.path.join(gt_base, frame)
        if not os.path.isdir(gt_dir):
            continue
        for fn in sorted(f for f in os.listdir(gt_dir) if f.endswith(".jpg")):
            obj = os.path.splitext(fn)[0]
            pred = os.path.join(pred_base, f"{frame}_{obj}.png")
            if not os.path.exists(pred):
                ious.append(0.0)
                detail[f"{frame}/{obj}"] = 0.0
                continue
            iou = mask_iou(
                load_binary(os.path.join(gt_dir, fn)),
                load_binary(pred, to_gray=True),
            )
            ious.append(iou)
            detail[f"{frame}/{obj}"] = iou
    arr = np.asarray(ious)
    return dict(
        miou=float(arr.mean()) if len(arr) else float("nan"),
        acc_025=float((arr > 0.25).mean()) if len(arr) else float("nan"),
        acc_05=float((arr > 0.5).mean()) if len(arr) else float("nan"),
        n=len(arr),
        per_object=detail,
    )


def main(argv=None):
    p = argparse.ArgumentParser("Compute LeRF IoU")
    p.add_argument("--scene_name", required=True, choices=list(SCENE_EVAL_FRAMES))
    p.add_argument("--gt_base", required=True)
    p.add_argument("--pred_base", required=True)
    args = p.parse_args(argv)
    r = evaluate(args.gt_base, args.pred_base, args.scene_name)
    print(json.dumps({k: v for k, v in r.items() if k != "per_object"}, indent=2))


if __name__ == "__main__":
    main()
