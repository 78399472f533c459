"""Image-quality metrics over render directories.

Port of opengaussian_tpu/eval/metrics.py (reference metrics.py: PSNR, SSIM
and LPIPS over renders/ against gt/; results.json). PSNR is
train/losses.psnr, SSIM ops/ssim.ssim, LPIPS eval/lpips.py (VGG16 in
float32, from a local weights file; reported as null, with one warning,
where there is none):

    python -m opengaussian_tpu_torch.eval.metrics -m <model> [<model> ...]
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from PIL import Image

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.ops.ssim import ssim
from opengaussian_tpu_torch.train.losses import psnr


def lpips_fn(device="cuda"):
    """The self-contained VGG-LPIPS on `device` (None when no local weights
    exist)."""
    from opengaussian_tpu_torch.eval.lpips import get_lpips

    return get_lpips(device)


def read_rgb(path: str) -> np.ndarray:
    """An image file as [H, W, 3] float32 in [0, 1]."""
    return np.asarray(Image.open(path), np.float32)[..., :3] / 255


@torch.no_grad()
def evaluate_dirs(renders_dir: str, gt_dir: str, device="cuda") -> dict:
    """PSNR, SSIM and LPIPS of every image of renders_dir against the file
    of the same name in gt_dir. -> {"results": the means (LPIPS None
    without weights), "per_view": {metric: {name: value}}}."""
    dev = resolve_device(device)
    names = sorted(os.listdir(renders_dir))
    per_view = {"PSNR": {}, "SSIM": {}, "LPIPS": {}}
    lp = lpips_fn(dev)
    for n in names:
        a = read_rgb(os.path.join(renders_dir, n))
        b = read_rgb(os.path.join(gt_dir, n))
        at, bt = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        per_view["PSNR"][n] = float(psnr(at, bt))
        per_view["SSIM"][n] = float(ssim(at, bt))
        if lp:
            per_view["LPIPS"][n] = lp(at, bt)
    # LPIPS stays in the results as None when its weights are absent, so
    # that "metric unavailable" reads apart from "not applicable"
    agg = {k: (float(np.mean(list(v.values()))) if v else None) for k, v in per_view.items()}
    return {"results": agg, "per_view": per_view}


def main(argv=None, device="cuda"):
    """Evaluate test/<method>/renders against gt under each model path and
    write <model>/results.json."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    args = p.parse_args(argv)
    dev = resolve_device(device)
    for mp in args.model_paths:
        full = {}
        test_dir = os.path.join(mp, "test")
        for method in sorted(os.listdir(test_dir)) if os.path.isdir(test_dir) else []:
            md = os.path.join(test_dir, method)
            out = evaluate_dirs(os.path.join(md, "renders"), os.path.join(md, "gt"), dev)
            full[method] = out["results"]
            print(mp, method, out["results"])
        with open(os.path.join(mp, "results.json"), "w") as f:
            json.dump(full, f, indent=2)


if __name__ == "__main__":
    main()
