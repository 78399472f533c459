"""Stage-0 convergence on a known scene (the port's counterpart of the JAX
package's examples/synthetic_convergence.py): GT images are renders of
three colored blobs of 3,000 splats from 24 poses at 640x480
(tools/synthetic.py:convergence_scene); training starts from 800 noisy gray
points, densifies every 100 iterations from 500 to 2,500 (the opacity
reset interval, 3,000, lies past that window: no reset) and must recover
the scene on the 4 held-out views.

`run` trains to 4,000 iterations and returns, and prints, the test PSNR,
L1 and alive count at iterations 0, 500, 1,000, 2,000, 3,000 and 4,000,
then the PSNR of each held-out view and the mean and least PSNR of the
training views, with the run's wall seconds and its peak device memory; it
writes a side-by-side PNG (render | GT) of held-out view 0. The JAX script's
docstring records PSNR 26.2 / 36.1 / 39.0 at 500 / 2,000 / 4,000 and 6,381
splats at the end.

    python -m opengaussian_tpu_torch.tools.synthetic_convergence [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from opengaussian_tpu_torch.config import OptimizationConfig
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.tools import synthetic
from opengaussian_tpu_torch.tools.quality_run import (make_trainer, peak_mib, peak_start,
                                                      slots_lost)
from opengaussian_tpu_torch.train.loop import eval_view

CHECKPOINTS = (500, 1000, 2000, 3000, 4000)


def opt_config() -> OptimizationConfig:
    """Stage 0 only: the feature stages start past the run."""
    return OptimizationConfig(
        iterations=100_000, start_ins_feat_iter=10 ** 6, start_root_cb_iter=10 ** 6,
        start_leaf_cb_iter=10 ** 6, densify_from_iter=500, densify_until_iter=2500,
        densification_interval=100, opacity_reset_interval=3000,
        densify_grad_threshold=0.0004, sam_level=3)


def run(device="cuda", out: str | None = None, checkpoints: tuple = CHECKPOINTS,
        size: synthetic.ConvergenceSize = synthetic.CONVERGENCE_FULL) -> dict:
    """Train stage 0 to the last checkpoint, evaluating at 0 and at each.
    The Trainer at its defaults. checkpoints and size: a shorter run on a
    smaller scene (the tests' CPU smoke). -> {"curve":
    [{iteration, psnr, l1, num_alive}], "test_psnr_by_view", "train_psnr",
    "train_psnr_min", "wall_s", "peak_device_mib", "device",
    "slots_lost", "png"}; slots_lost is the most slots any step lost."""
    dev = resolve_device(device)
    out = out or tempfile.mkdtemp(prefix="convergence_")
    os.makedirs(out, exist_ok=True)
    base = peak_start(dev)
    t_start = time.time()
    scene, rcfg = synthetic.convergence_scene(size, dev)
    tr = make_trainer(scene, opt_config(), os.path.join(out, "model"), rcfg, dev)
    curve = []

    def point():
        m = tr.evaluate()
        curve.append(dict(iteration=tr.iteration, psnr=round(m["psnr"], 3),
                          l1=round(m["l1"], 5), num_alive=int(tr.state.num_alive)))
        print(f"it {tr.iteration}: test PSNR {m['psnr']:.2f}  pts {curve[-1]['num_alive']}",
              flush=True)

    point()
    for k in checkpoints:
        tr.train(until=k, log_every=10 ** 9)
        point()
    # per view at the end: whether an error is the held-out views' alone or
    # the training views' too
    test = [eval_view(tr.state, tr.test_bundle, i, tr.bg, tr.rcfg)
            for i in range(tr.test_bundle.num_views)]
    train = [float(eval_view(tr.state, tr.bundle, i, tr.bg, tr.rcfg)[1])
             for i in range(tr.bundle.num_views)]
    img = test[0][0]
    peak = peak_mib(dev, base)
    from PIL import Image

    side = np.concatenate([img.cpu().numpy(), scene.test_views[0].gt_image], axis=1)
    png = os.path.join(out, "converge_side_by_side.png")
    Image.fromarray((np.clip(side, 0, 1) * 255).astype(np.uint8)).save(png)
    result = dict(curve=curve, test_psnr_by_view=[round(float(p), 3) for _i, p, _l in test],
                  train_psnr=round(float(np.mean(train)), 3),
                  train_psnr_min=round(min(train), 3), wall_s=round(time.time() - t_start, 1),
                  peak_device_mib=peak,
                  device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  slots_lost=slots_lost(tr), png=png)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="directory of the PNG and the model "
                                                "(default: a new temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, out=args.out)


if __name__ == "__main__":
    main()
