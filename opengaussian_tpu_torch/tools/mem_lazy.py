"""Host memory of eager against lazy scene loading (the port's counterpart
of the JAX repo's tools/mem_lazy.py).

    python -m opengaussian_tpu_torch.tools.mem_lazy [--views 60]

Writes a COLMAP scene of --views frames at 648x484 (PNG images, [4, H, W]
int16 SAM and [M, 512] CLIP sidecars), then, for each mode in a child
process that imports only opengaussian_tpu_torch, loads the scene
(`data.dataset.load_scene(lazy=...)`), stacks its views in host memory
(`train/loop.py:bundle_views(host=True)`, the save_memory bundle) and takes
5 one-view windows to the device (`bundle_window`, the training loop's per
step copy), reading the process's VmRSS from /proc after each phase. The
pixel sums of the windows must agree between the modes. Prints a table and
one JSON line last: `views`, `eager_mb` and `lazy_mb` (the RSS each mode's
scene adds) and `device`, the card's name and power limit. The figures are
the host's: the tool runs on the CPU either way, and `device` only chooses
where the windows go. No kernel of the port runs on its path (copies
alone), so it holds none against a plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.tools import timing

W, H = 648, 484
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("baseline_mb", "after_load_mb", "after_bundle_mb", "after_5_windows_mb")

CHILD = r"""
import json, sys

def rss_mb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0

root, mode, device = sys.argv[1], sys.argv[2], sys.argv[3]
import torch
out = {"baseline_mb": rss_mb()}
from opengaussian_tpu_torch.data import dataset
from opengaussian_tpu_torch.train.loop import bundle_views, bundle_window
scene = dataset.load_scene(root, lazy=(mode == "lazy"))
out["after_load_mb"] = rss_mb()
b = bundle_views(scene.train_views, sam_level=3, device=device, host=True)
out["after_bundle_mb"] = rss_mb()
s = 0.0
for i in range(5):
    s += float(bundle_window(b, i % b.num_views, device).gt_images.sum())
out["after_5_windows_mb"] = rss_mb()
out["checksum"] = s
print(json.dumps(out))
"""


def make_scene(root: str, n_views: int) -> None:
    """tools/mem_lazy.py:make_scene, written with the port's COLMAP writers."""
    from PIL import Image

    from opengaussian_tpu_torch.data import colmap

    for d in ("sparse/0", "images", "language_features"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.default_rng(0)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([600.0, 600.0, W / 2, H / 2]))}
    imgs = {}
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])
        imgs[i + 1] = colmap.ColmapImage(i + 1, q, np.array([0.0, 0.0, 4.0]), 1,
                                         f"img_{i:03d}.png")
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"img_{i:03d}.png"))
        sam = np.zeros((4, H, W), np.int16)
        sam[3] = (np.arange(W)[None, :] * 8 // W + 1).astype(np.int16)
        np.save(os.path.join(root, "language_features", f"img_{i:03d}_s.npy"), sam)
        np.save(os.path.join(root, "language_features", f"img_{i:03d}_f.npy"),
                rng.random((9, 512)).astype(np.float32))
    colmap.write_cameras_binary(cams, os.path.join(root, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(root, "sparse/0/images.bin"))
    xyz = rng.normal(size=(1000, 3))
    rgb = (rng.random((1000, 3)) * 255).astype(np.uint8)
    colmap.write_points3d_binary(xyz, rgb, os.path.join(root, "sparse/0/points3D.bin"))


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"
    results = {}
    with tempfile.TemporaryDirectory(prefix="memlazy_") as root:
        print(f"writing {args.views} views at {W}x{H} ...", file=sys.stderr, flush=True)
        make_scene(root, args.views)
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        for mode in ("eager", "lazy"):
            r = subprocess.run([sys.executable, "-c", CHILD, root, mode, str(dev)],
                               capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
            if r.returncode != 0:
                raise RuntimeError(f"mem_lazy {mode} child failed:\n{r.stdout}{r.stderr}")
            results[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    if abs(results["eager"]["checksum"] - results["lazy"]["checksum"]) >= 1e-3:
        raise AssertionError(f"the modes' windows differ: {results}")
    print(f"\n{'phase':>20s} {'eager MB':>10s} {'lazy MB':>10s}", file=sys.stderr)
    for k in PHASES:
        print(f"{k:>20s} {results['eager'][k]:>10.1f} {results['lazy'][k]:>10.1f}",
              file=sys.stderr)
    e = results["eager"]["after_5_windows_mb"] - results["eager"]["baseline_mb"]
    lz = results["lazy"]["after_5_windows_mb"] - results["lazy"]["baseline_mb"]
    print(f"\nscene-attributable RSS: eager {e:.0f} MB vs lazy {lz:.0f} MB ({args.views} views; "
          f"identical pixel checksums) [{card}]", file=sys.stderr, flush=True)
    out = {"views": args.views, "eager_mb": round(e, 1), "lazy_mb": round(lz, 1),
           "device": card}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
