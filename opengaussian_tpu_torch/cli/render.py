"""Render trained models: RGB + instance-feature maps per split.

Port of opengaussian_tpu/cli/render.py (reference render.py:33-86): writes
renders/, gt/, ins_feat1/, ins_feat2/ (and sam_mask/ colorizations when
sidecars exist) for the train and test splits, on the GPU.

    python -m opengaussian_tpu_torch.cli.render -m <model> -s <scene>
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from opengaussian_tpu_torch.data.dataset import load_scene
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.loading import load_model
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.render import render
from opengaussian_tpu_torch.utils.masks import decode_sam_level


def _save(path, arr):
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    Image.fromarray((np.clip(np.asarray(arr), 0, 1) * 255).astype(np.uint8)).save(path)


def mask_colors(n, seed=42):
    """Deterministic mask colorization (reference train.py:47)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (max(n, 500), 3)).astype(np.uint8)[:n]


def render_set(out_dir, split, views, state, rcfg, bg, sam_level) -> int:
    """Render every view of one split; -> the number of views rendered."""
    dirs = {k: os.path.join(out_dir, split, "ours", k)
            for k in ("renders", "gt", "ins_feat1", "ins_feat2", "sam_mask")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, v in enumerate(views):
        out = render(v.camera, state, bg, 3, rcfg, render_color=True,
                     render_feat_map=True, origin_feat=True)
        name = f"{i:05d}.png"
        _save(os.path.join(dirs["renders"], name), out.render)
        _save(os.path.join(dirs["gt"], name), v.gt_image)
        _save(os.path.join(dirs["ins_feat1"], name), out.ins_feat[..., :3])
        _save(os.path.join(dirs["ins_feat2"], name), out.ins_feat[..., 3:6])
        if v.sam_mask is not None:
            ids = decode_sam_level(np.asarray(v.sam_mask), sam_level)
            cols = mask_colors(int(ids.max()) + 1)
            Image.fromarray(cols[ids]).save(os.path.join(dirs["sam_mask"], name))
    return len(views)


def main(argv=None, device="cuda") -> int:
    """Parse the CLI flags and render both splits on `device`; -> the number
    of views rendered."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--images", default="images")
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--sam_level", type=int, default=3)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    scene = load_scene(args.source_path, images=args.images,
                       white_background=args.white_background,
                       eval_split=args.eval, resolution=args.resolution)
    state, _, it = load_model(args.model_path, args.iteration, device=dev)
    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    rcfg = RasterizeConfig()
    n = 0
    with torch.no_grad():
        if not args.skip_train:
            n += render_set(args.model_path, "train", scene.train_views, state,
                            rcfg, bg, args.sam_level)
        if not args.skip_test and scene.test_views:
            n += render_set(args.model_path, "test", scene.test_views, state,
                            rcfg, bg, args.sam_level)
    print(f"rendered iteration {it} to {args.model_path}")
    return n


if __name__ == "__main__":
    main()
