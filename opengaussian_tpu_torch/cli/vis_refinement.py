"""Headless multi-view SAM refinement visualizer (port of
opengaussian_tpu/cli/vis_refinement.py).

Counterpart of the reference's `visualize_multiview_refinement.py:13-524`
(camera-pose/FOV 3D plots + refinement inspection), redesigned for headless
runs: instead of interactive matplotlib windows it writes

  <out>/refinement_vis/cameras_frustums.png   3D plot: camera positions,
      FOV frustum pyramids, a Gaussian subsample (the reference's
      plot_cameras_and_gaussians)
  <out>/refinement_vis/view_<name>_before.png colorized original SAM ids
  <out>/refinement_vis/view_<name>_after.png  colorized refined global ids

Auto-detects dataset vs training-output directories the same way the
reference does (point_cloud/ + cfg_args present => output dir, source path
read from the persisted config).

The refinement runs on the GPU (one K1 launch per camera for its depth
render); `main(argv, device="cpu")` runs the plain path. matplotlib is
imported only to draw the frustum plot.

Usage:
    python -m opengaussian_tpu_torch.cli.vis_refinement -s /data/scene -m out/run \
        --max_cameras 8 --max_gaussians 500
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def detect_paths(source_path: str):
    """-> (dataset_path, model_path|None), mirroring the reference's
    _detect_paths (visualize_multiview_refinement.py:52-113)."""
    cfg = os.path.join(source_path, "cfg_args.json")
    if os.path.isdir(os.path.join(source_path, "point_cloud")) and os.path.exists(cfg):
        with open(cfg) as f:
            src = json.load(f).get("model", {}).get("source_path", "")
        if src and os.path.isdir(src):
            return src, source_path
        raise SystemExit(f"original dataset not found (cfg source_path={src!r})")
    return source_path, None


def frustum_corners(cam, depth: float):
    """[5, 3] world-space camera center + 4 image-plane corners at `depth`."""
    R = cam.R_w2c.cpu().numpy()
    t = cam.t_w2c.cpu().numpy()
    c = -R.T @ t
    corners = []
    for px, py in ((0, 0), (cam.width - 1, 0), (cam.width - 1, cam.height - 1),
                   (0, cam.height - 1)):
        x = (px - float(cam.cx)) / float(cam.fx) * depth
        y = (py - float(cam.cy)) / float(cam.fy) * depth
        corners.append(R.T @ (np.array([x, y, depth]) - t))
    return np.stack([c] + corners)


def plot_cameras_and_gaussians(cams, points, path: str, depth: float):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    if len(points):
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=2, c="gray",
                   alpha=0.4, label=f"gaussians ({len(points)})")
    for i, cam in enumerate(cams):
        fr = frustum_corners(cam, depth)
        ax.scatter(*fr[0], c="red", s=30)
        ax.text(*fr[0], f"cam{i}", fontsize=7)
        for j in range(1, 5):
            ax.plot(*np.stack([fr[0], fr[j]]).T, c="blue", lw=0.6, alpha=0.7)
        ring = fr[[1, 2, 3, 4, 1]]
        ax.plot(ring[:, 0], ring[:, 1], ring[:, 2], c="blue", lw=0.6, alpha=0.7)
    ax.set_title("cameras, FOV frustums, gaussians")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source_path", "-s", required=True,
                   help="dataset dir OR training output dir")
    p.add_argument("--model_path", "-m", default=None)
    p.add_argument("--out", default=None, help="default: <model|.>/refinement_vis")
    p.add_argument("--max_cameras", type=int, default=8)
    p.add_argument("--max_gaussians", type=int, default=500)
    p.add_argument("--sam_level", type=int, default=3)
    p.add_argument("--frustum_depth", type=float, default=0.5)
    args = p.parse_args(argv)

    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.device import resolve_device
    from opengaussian_tpu_torch.models.gaussians import create_from_pcd
    from opengaussian_tpu_torch.models.loading import load_model
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.refine.sam_refiner import refine_sam_masks
    from opengaussian_tpu_torch.train.loop import bundle_views
    from opengaussian_tpu_torch.train.observe import _save_png, mask_palette

    dev = resolve_device(device)

    dataset_path, model_path = detect_paths(args.source_path)
    model_path = args.model_path or model_path
    out = args.out or os.path.join(model_path or ".", "refinement_vis")
    os.makedirs(out, exist_ok=True)

    scene = load_scene(dataset_path)
    views = sorted(scene.train_views, key=lambda v: v.image_name)
    step = max(1, len(views) // args.max_cameras)
    views = views[::step][: args.max_cameras]
    bundle = bundle_views(views, args.sam_level, dev)
    cams = [bundle.camera(i) for i in range(bundle.num_views)]

    if model_path:
        state, _, it = load_model(model_path, device=dev)
        print(f"loaded trained model from {model_path} (iteration {it})")
    else:
        state = create_from_pcd(
            np.asarray(scene.points, np.float32),
            np.asarray(scene.colors, np.float32), device=dev,
        )
        print("no trained model: using SfM initialization")

    alive = np.flatnonzero(state.alive.cpu().numpy())
    sel = alive[:: max(1, len(alive) // args.max_gaussians)][: args.max_gaussians]
    pts = state.means.cpu().numpy()[sel]
    plot_cameras_and_gaussians(
        cams, pts, os.path.join(out, "cameras_frustums.png"),
        args.frustum_depth * float(scene.cameras_extent or 1.0),
    )

    sam = bundle.sam_ids.cpu().numpy()
    refined = refine_sam_masks(state, cams, sam, RasterizeConfig())
    pal_b = mask_palette(int(sam.max()))
    pal_a = mask_palette(int(refined.max()) if refined.max() > 0 else 1)
    for i, v in enumerate(views):
        _save_png(os.path.join(out, f"view_{v.image_name}_before.png"),
                  pal_b[sam[i]] / 255.0)
        after = np.maximum(refined[i], 0)  # void -> background color
        _save_png(os.path.join(out, f"view_{v.image_name}_after.png"),
                  pal_a[after] / 255.0)
    print(f"wrote {2 * len(views) + 1} images to {out}")


if __name__ == "__main__":
    main()
