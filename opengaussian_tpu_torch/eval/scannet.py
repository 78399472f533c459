"""ScanNet open-vocabulary point-cloud semantic segmentation eval.

Port of opengaussian_tpu/eval/scannet.py (reference scripts/eval_scannet.py):
loads the GT labels from <scene>_vh_clean_2.labels.ply (NYU40 ids; relies on
frozen init points so Gaussian i corresponds to GT vertex i), ignores points
with opacity < 0.1, predicts each point's class as the argmax over
text-feature cosine similarities of its leaf cluster, and reports per-class
IoU / mIoU / Acc / mAcc over the 19/15/10-class subsets. Host numpy only:

    python -m opengaussian_tpu_torch.eval.scannet -m <model> \
        --gt_labels <scene>_vh_clean_2.labels.ply --text_features <json>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

NYU40 = {
    0: "unlabeled", 1: "wall", 2: "floor", 3: "cabinet", 4: "bed", 5: "chair",
    6: "sofa", 7: "table", 8: "door", 9: "window", 10: "bookshelf",
    11: "picture", 12: "counter", 13: "blinds", 14: "desk", 15: "shelves",
    16: "curtain", 17: "dresser", 18: "pillow", 19: "mirror", 20: "floormat",
    21: "clothes", 22: "ceiling", 23: "books", 24: "refrigerator",
    25: "television", 26: "paper", 27: "towel", 28: "showercurtain", 29: "box",
    30: "whiteboard", 31: "person", 32: "nightstand", 33: "toilet", 34: "sink",
    35: "lamp", 36: "bathtub", 37: "bag", 38: "otherstructure",
    39: "otherfurniture", 40: "otherprop",
}
# reference class subsets (scripts/eval_scannet.py:109-111)
TARGET_IDS = {
    19: [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36],
    15: [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 33, 34],
    10: [1, 2, 4, 5, 6, 7, 8, 9, 10, 33],
}
MIN_OCCU = 2  # scripts/eval_scannet.py:140


def calculate_metrics(gt: np.ndarray, pred: np.ndarray, total_classes: int):
    """Exact semantics of scripts/eval_scannet.py:55-93 (0 = ignored)."""
    pred = pred.copy()
    pred[gt == 0] = 0
    ious = np.zeros(total_classes)
    correct = np.zeros(total_classes)
    total = np.zeros(total_classes)
    for c in range(1, total_classes):
        inter = np.sum((gt == c) & (pred == c))
        union = np.sum((gt == c) | (pred == c))
        ious[c] = inter / union if union else 0.0
        correct[c] = inter
        total[c] = np.sum(gt == c)
    valid_gt = np.unique(gt)
    valid_gt = valid_gt[valid_gt != 0]
    mean_iou = float(ious[valid_gt].mean()) if len(valid_gt) else float("nan")
    mask = gt != 0
    acc = float(((gt == pred) & mask).sum() / max(mask.sum(), 1))
    with np.errstate(invalid="ignore", divide="ignore"):
        cls_acc = np.where(total > 0, correct / np.maximum(total, 1), np.nan)
    mean_acc = float(np.nanmean(cls_acc[valid_gt])) if len(valid_gt) else float("nan")
    return ious, mean_iou, acc, mean_acc


def predict_point_classes(lang: dict, text_feats: np.ndarray, num_leaves: int):
    """-> per-point 1-based class prediction via leaf argmax
    (scripts/eval_scannet.py:150-163)."""
    leaf_feat = lang["leaf_feat"].copy()
    leaf_feat[lang["occu_count"] < MIN_OCCU] = 0.0
    leaf_ind = np.clip(lang["leaf_ind"], 0, num_leaves - 1)
    t = text_feats / (np.linalg.norm(text_feats, axis=1, keepdims=True) + 1e-12)
    f = leaf_feat / (np.linalg.norm(leaf_feat, axis=1, keepdims=True) + 1e-12)
    sim = t @ f.T  # [num_cls, num_leaf]
    leaf_cls = np.argmax(sim, axis=0)  # [num_leaf]
    return leaf_cls[leaf_ind] + 1


def evaluate_scene(model_path: str, gt_labels_ply: str, text_features_json: str,
                   subset: int = 19) -> dict:
    from opengaussian_tpu_torch.data.ply import read_ply

    v = read_ply(gt_labels_ply)
    labels = np.asarray(v["label"], np.int64)

    target_ids = TARGET_IDS[subset]
    remap = {orig: i + 1 for i, orig in enumerate(target_ids)}
    gt = np.zeros_like(labels)
    for orig, new in remap.items():
        gt[labels == orig] = new

    # opacity gate from the trained point cloud (index-aligned with GT)
    from opengaussian_tpu_torch.models.loading import find_iteration

    it = find_iteration(model_path)
    gs = read_ply(os.path.join(model_path, f"point_cloud/iteration_{it}/point_cloud.ply"))
    opac = 1 / (1 + np.exp(-np.asarray(gs["opacity"])))
    n = min(len(gt), len(opac))
    gt = gt[:n]
    gt[opac[:n] < 0.1] = 0

    lang = {k: np.load(os.path.join(model_path, "cluster_lang.npz"))[k]
            for k in ("leaf_feat", "leaf_score", "occu_count", "leaf_ind")}
    with open(text_features_json) as f:
        tf = json.load(f)
    names = [NYU40[i] for i in target_ids]
    text_feats = np.stack([np.asarray(tf[nm], np.float32) for nm in names])

    pred = predict_point_classes(lang, text_feats, lang["leaf_feat"].shape[0])[:n]
    ious, miou, acc, macc = calculate_metrics(gt, pred, len(names) + 1)
    return dict(
        per_class_iou={nm: float(ious[i + 1]) for i, nm in enumerate(names)},
        miou=miou, acc=acc, macc=macc, subset=subset,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--gt_labels", required=True, help="*_vh_clean_2.labels.ply")
    p.add_argument("--text_features", required=True)
    p.add_argument("--classes", type=int, default=19, choices=(19, 15, 10))
    args = p.parse_args(argv)
    r = evaluate_scene(args.model_path, args.gt_labels, args.text_features, args.classes)
    print(json.dumps(r, indent=2))


if __name__ == "__main__":
    main()
