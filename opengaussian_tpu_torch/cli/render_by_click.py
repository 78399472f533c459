"""Click -> 3D object selection.

Port of opengaussian_tpu/cli/render_by_click.py (reference
scripts/render_by_click.py:55-67, 142-161, 168-245): read the 6-D instance
feature at a clicked pixel from the feature-map PNGs that cli/render.py
wrote (ins_feat1/ins_feat2, color = (feat + 1) / 2), find the nearest
coarse (root) codebook center, then the nearest leaf within that root, and
render that leaf's splats as RGB on white with the KNN outlier mask and the
leaf-level scale cull, once per training view (one K1 launch each on the
GPU), into click2obj/ours_<it>/:

    python -m opengaussian_tpu_torch.cli.render_by_click -m <model> -s <scene> \\
        --view 00005 --click X Y
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from PIL import Image


def decode_features(ins_feat1_png: str, ins_feat2_png: str) -> np.ndarray:
    """[H, W, 6]: the feature encoded at every pixel of the two feature maps."""
    a = np.asarray(Image.open(ins_feat1_png), np.float32)[..., :3] / 255.0
    b = np.asarray(Image.open(ins_feat2_png), np.float32)[..., :3] / 255.0
    return (np.concatenate([a, b], axis=-1) * 2.0 - 1.0).astype(np.float32)


def decode_feature_at(ins_feat1_png: str, ins_feat2_png: str, x: int, y: int) -> np.ndarray:
    """The 6-D feature encoded at pixel (x, y) of the two feature maps."""
    return decode_features(ins_feat1_png, ins_feat2_png)[y, x]


def leaf_slots(n_leaf_centers: int, k1: int) -> int:
    """Leaf slots per root: the leaf codebook holds k1 * k2 centers and the
    "unassigned" bucket (reference scripts/render_by_click.py:70)."""
    return (n_leaf_centers - 1) // k1


def nearest_roots(feats: np.ndarray, root_centers: np.ndarray) -> np.ndarray:
    """[M] the root whose normalized feature (the first 6 of the 9-D coarse
    centers) lies nearest each of feats [M, 6]. Root centers store raw
    (unnormalized) features; the rendered feature map encodes the
    L2-normalized feature, so compare normalized."""
    rc = root_centers[:, :6]
    rcn = rc / (np.linalg.norm(rc, axis=1, keepdims=True) + 1e-12)
    return np.argmin(np.linalg.norm(rcn[None] - feats[:, None], axis=-1), axis=1)


def select_leaf_by_feature(feat6: np.ndarray, root_centers: np.ndarray,
                           leaf_centers: np.ndarray, leaf_num: int) -> int:
    """Nearest root, then nearest leaf among that root's slots."""
    root = int(nearest_roots(feat6[None], root_centers)[0])
    lc = leaf_centers[root * leaf_num : (root + 1) * leaf_num]
    lcn = lc / (np.linalg.norm(lc, axis=1, keepdims=True) + 1e-12)
    leaf = int(np.argmin(np.linalg.norm(lcn - feat6[None], axis=1)))
    return root * leaf_num + leaf


def main(argv=None, device="cuda") -> dict:
    """Parse the flags and render the clicked object on `device`. -> leaf,
    the splats selected before and after the KNN mask, those of them that
    pass the scale cull, the output directory, the frames rendered and host
    seconds of each frame's render (to its PNG, which waits for the
    device)."""
    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.device import resolve_device
    from opengaussian_tpu_torch.models.loading import load_model
    from opengaussian_tpu_torch.ops.knn import selection_mask
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import passes_scale_cull, render_selection, save_selection

    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--view", required=True, help="image index used for the click (e.g. 00005)")
    p.add_argument("--click", nargs=2, type=int, required=True, metavar=("X", "Y"))
    args = p.parse_args(argv)
    dev = resolve_device(device)

    state, kms, it = load_model(args.model_path, args.iteration, device=dev)
    if kms is None:
        raise ValueError("click selection needs trained codebooks")
    fdir = os.path.join(args.model_path, "train", "ours")
    feat = decode_feature_at(
        os.path.join(fdir, "ins_feat1", f"{args.view}.png"),
        os.path.join(fdir, "ins_feat2", f"{args.view}.png"),
        args.click[0], args.click[1],
    )
    k1 = kms.centers.shape[0]
    leaf_num = leaf_slots(kms.leaf_centers.shape[0], k1)
    leaf = select_leaf_by_feature(feat, kms.centers.cpu().numpy(),
                                  kms.leaf_centers.cpu().numpy(), leaf_num)
    print(f"click {args.click} -> leaf {leaf} (root {leaf // leaf_num})")

    member, n_before = selection_mask(kms.leaf_cls_ids.cpu().numpy(),
                                      state.alive.cpu().numpy(),
                                      state.means.cpu().numpy(), [leaf])
    small = passes_scale_cull(state).cpu().numpy()
    rec = dict(leaf=leaf, members=n_before, after_knn=int(member.sum()),
               after_cull=int((member & small).sum()), frames=[], render_s=[])
    print(f"leaf {leaf}: {n_before} splats, {rec['after_knn']} after the KNN mask, "
          f"{rec['after_cull']} of them under the scale cull")

    scene = load_scene(args.source_path, eval_split=False, resolution=args.resolution)
    rcfg = RasterizeConfig()
    out_dir = os.path.join(args.model_path, "click2obj", f"ours_{it}")
    os.makedirs(out_dir, exist_ok=True)
    member_t = torch.as_tensor(member, device=dev)
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        for v in scene.train_views:
            t0 = time.perf_counter()
            out = render_selection(v.camera, state, bg, member_t, rcfg)
            save_selection(os.path.join(out_dir, f"{v.image_name}_leaf{leaf}.png"),
                           out.cluster_imgs)
            rec["render_s"].append(time.perf_counter() - t0)
            rec["frames"].append(v.image_name)
    print(f"wrote selections to {out_dir}")
    return dict(rec, out_dir=out_dir)


if __name__ == "__main__":
    main()
