"""Full evaluation over the vanilla-3DGS scene suites.

Port of opengaussian_tpu/cli/full_eval.py (the reference's `full_eval.py`, a
vanilla-3DGS leftover that shells out to train.py / render.py / metrics.py
over the MipNeRF360, Tanks&Temples and DeepBlending scene lists,
full_eval.py:15-89). Same scene tables and per-suite image-dir conventions
(images_4 outdoor / images_2 indoor for MipNeRF360), driving the port's own
train / render / metrics entry points in-process, on the GPU.

Usage:
    python -m opengaussian_tpu_torch.cli.full_eval -m360 /data/360 -tat /data/tnt \
        -db /data/db --output_path ./eval
    python -m opengaussian_tpu_torch.cli.full_eval --skip_training --skip_rendering \
        --output_path ./eval
"""

from __future__ import annotations

import argparse
import os

from opengaussian_tpu_torch.device import resolve_device

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]
ALL_SCENES = (MIPNERF360_OUTDOOR + MIPNERF360_INDOOR + TANKS_AND_TEMPLES
              + DEEP_BLENDING)


def scene_sources(args) -> list[tuple[str, str, str]]:
    """-> [(scene, source_path, images_dir)]."""
    out = []
    for s in MIPNERF360_OUTDOOR:
        out.append((s, os.path.join(args.mipnerf360, s), "images_4"))
    for s in MIPNERF360_INDOOR:
        out.append((s, os.path.join(args.mipnerf360, s), "images_2"))
    for s in TANKS_AND_TEMPLES:
        out.append((s, os.path.join(args.tanksandtemples, s), "images"))
    for s in DEEP_BLENDING:
        out.append((s, os.path.join(args.deepblending, s), "images"))
    return out


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description="Full evaluation over 3DGS suites")
    p.add_argument("--skip_training", action="store_true")
    p.add_argument("--skip_rendering", action="store_true")
    p.add_argument("--skip_metrics", action="store_true")
    p.add_argument("--output_path", default="./eval")
    p.add_argument("--mipnerf360", "-m360", default=None)
    p.add_argument("--tanksandtemples", "-tat", default=None)
    p.add_argument("--deepblending", "-db", default=None)
    p.add_argument("--iterations", type=int, default=30_000,
                   help="stage-0-only run like the reference's vanilla eval")
    args = p.parse_args(argv)
    device = resolve_device(device)

    need_sources = not (args.skip_training and args.skip_rendering)
    if need_sources and not (args.mipnerf360 and args.tanksandtemples
                             and args.deepblending):
        p.error("-m360/-tat/-db are required unless both training and "
                "rendering are skipped")

    if not args.skip_training:
        from opengaussian_tpu_torch.cli import train as train_cli

        for scene, source, images in scene_sources(args):
            model = os.path.join(args.output_path, scene)
            print(f"=== training {scene} ===", flush=True)
            train_cli.main([
                "-s", source, "-m", model, "--images", images, "--eval",
                "--iterations", str(args.iterations),
                # stage-0 only: vanilla 3DGS has no feature/codebook stages
                "--start_ins_feat_iter", str(args.iterations),
                "--start_root_cb_iter", str(args.iterations + 1),
                "--start_leaf_cb_iter", str(args.iterations + 2),
                "--test_iterations", "-1",
            ], device=device)

    if not args.skip_rendering:
        from opengaussian_tpu_torch.cli import render as render_cli

        for scene, source, images in scene_sources(args):
            model = os.path.join(args.output_path, scene)
            print(f"=== rendering {scene} ===", flush=True)
            render_cli.main([
                "-m", model, "-s", source, "--images", images,
                "--skip_train",
            ], device=device)

    if not args.skip_metrics:
        from opengaussian_tpu_torch.eval import metrics as metrics_cli

        paths = [os.path.join(args.output_path, s) for s in ALL_SCENES
                 if os.path.isdir(os.path.join(args.output_path, s))]
        if paths:
            metrics_cli.main(["-m"] + paths, device=device)
        else:
            print(f"no evaluated scenes under {args.output_path}")


if __name__ == "__main__":
    main()
