"""Training-process observability: periodic PNG dumps and TensorBoard image
grids.

Port of opengaussian_tpu/train/observe.py (reference train.py:502-566:
renders/gt every 1000 iterations, 100 in stage 2.2, plus per-stage
instance-feature halves, silhouette, colorized SAM mask and pseudo features
under model_path/train_process/; and its TensorBoard image grids at test
iterations, train.py:976-984). A dump re-renders the step's view once, as
the JAX package does: one extra render (one or two K1 launches on the GPU)
per dump.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _save_png(path: str, arr):
    from PIL import Image

    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    img = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def mask_palette(n: int) -> np.ndarray:
    """[n+1, 3] float32 colors; id 0 is black. Seeded like the reference's
    predefined mask colors (reference train.py:44-47, seed 42)."""
    rng = np.random.default_rng(42)
    pal = rng.integers(0, 256, (max(n + 1, 512), 3)).astype(np.float32)
    pal[0] = 0.0
    return pal[: n + 1]


def dump_frequency(stage: str) -> int:
    return 100 if stage == "2.2" else 1000  # reference train.py:504-506


@torch.no_grad()
def dump_intermediate(trainer, it: int, stage: str, view_idx: int):
    """Save the reference's train_process/ artifact set for one view."""
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.render import render

    b, bi = trainer.view(trainer.bundle, view_idx)  # pseudo labels keep view_idx
    base = os.path.join(trainer.out_dir, "train_process")
    quant = None
    if stage == "2.1":
        quant = km.quantize(trainer.kms, trainer.state.ins_feat, "root")
    elif stage == "2.2":
        quant = km.quantize(trainer.kms, trainer.state.ins_feat, "leaf")
    out = render(b.camera(bi), trainer.state, trainer.bg, 3, trainer.rcfg,
                 render_color=True, render_feat_map=stage != "0", quantized_feat=quant)
    tag = f"{it:05d}"
    _save_png(os.path.join(base, "gt", tag + ".png"), b.gt_images[bi])
    _save_png(os.path.join(base, "renders", tag + ".png"), out.render)
    if stage == "0":
        return
    sub = {"1": "stage1", "2.1": "stage2_1", "2.2": "stage2_2"}[stage]
    feat = out.ins_feat.cpu().numpy()
    _save_png(os.path.join(base, sub, "ins_feat", tag + ".png"), feat[..., :3])
    _save_png(os.path.join(base, sub, "ins_feat2", tag + ".png"), feat[..., 3:6])
    if stage != "1":
        _save_png(os.path.join(base, sub, "silhouette", tag + ".png"), out.silhouette)
    sam = b.sam_ids[bi].cpu().numpy()
    if sam.max() > 0:
        pal = mask_palette(int(sam.max()))
        lvl = trainer.cfg.opt.sam_level
        _save_png(os.path.join(base, sub, f"gt_sam_mask_{lvl}", tag + ".png"),
                  pal[sam] / 255.0)
    if trainer.pseudo is not None:
        pf = trainer.pseudo.feat[view_idx].cpu().numpy()
        pdir = os.path.join(base, sub, "pseudo_ins_feat")
        _save_png(os.path.join(pdir, tag + "_1.png"), pf[..., :3])
        _save_png(os.path.join(pdir, tag + "_2.png"), pf[..., 3:6])


def tb_image_grids(trainer, images: list, gts: list, split: str,
                   first_test: bool):
    """TensorBoard image grids for up to 5 eval views (reference
    train.py:976-984); images and gts [H, W, 3] in [0, 1]."""
    if trainer.tb is None:
        return

    def nchw(x):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.clip(np.asarray(x), 0, 1).transpose(2, 0, 1)[None]

    for i, (img, gt) in enumerate(zip(images[:5], gts[:5])):
        trainer.tb.add_images(f"{split}_view_{i}/render", nchw(img),
                              global_step=trainer.iteration)
        if first_test:
            trainer.tb.add_images(f"{split}_view_{i}/ground_truth", nchw(gt),
                                  global_step=trainer.iteration)
