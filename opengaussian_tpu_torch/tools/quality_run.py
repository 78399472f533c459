"""The quality run: the port trained through all five stages on a synthetic
scene with known ground truth, scored on the reference's quality axes (the
port's counterpart of the JAX package's tools/quality_run.py; its figures
for the JAX package are QUALITY_r05.json).

The scene (tools/synthetic.py:quality_scene): 4 blob objects at 320x240,
20 training and 4 held-out views, 2,400 GT splats; training starts from 900
noisy gray points and runs stages 0 (to 1,400), 1 (to 1,900), 2.1 (to
2,200) and 2.2 (to 2,600), then stage 3. The scores:

  * stage-0 PSNR and the final PSNR and L1 on the held-out views;
  * the stage-2.2 loss trajectory, per root (one root trains per step);
  * the point-level purity of the root and leaf clusters against the GT
    object of each splat (the nearest blob center);
  * text retrieval and the silhouette mIoU through the render_by_text path:
    select_leaves_by_text on each object's CLIP vector, the KNN outlier
    mask, render_selection and its > 0.7 silhouette against the GT object
    mask of each held-out view.

`run` does the work and returns the result, which it also writes as JSON
(every key of QUALITY_r05.json, with `device` the card's name, plus
`peak_device_mib`, `trainer_options` and `slots_lost`, the slots the
steps lost, summed) with a side-by-side
PNG of held-out view 0 (render | GT). Training dumps are off
(`save_intermediate`): they render, and change nothing that is scored.

    python -m opengaussian_tpu_torch.tools.quality_run [--out DIR]
    python -m opengaussian_tpu_torch.tools.quality_run --fast --device cpu

--fast is the CPU size: 160x120, 6 + 2 views (one held out, as the JAX
script's split gives), 600 GT splats, 160 iterations.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from opengaussian_tpu_torch.cli.render_by_text import select_leaves_by_text
from opengaussian_tpu_torch.config import Config, ModelConfig, OptimizationConfig
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.ops.knn import statistical_outlier_mask
from opengaussian_tpu_torch.render import render_selection
from opengaussian_tpu_torch.tools import synthetic
from opengaussian_tpu_torch.train.loop import Trainer, eval_view

# the Trainer's options a caller may set; at their defaults, as in the JAX
# package, the first two are on and BLOCK_SIZES is ()
TRAINER_OPTIONS = ("autotune_budgets", "use_frozen_plans", "BLOCK_SIZES")


def make_trainer(scene, ocfg: OptimizationConfig, out_dir: str, rcfg, dev,
                 trainer_options: dict | None = None) -> Trainer:
    """A Trainer with the caller's options set as a user sets them, the
    others left at the Trainer's defaults; training dumps off."""
    opts = dict(trainer_options or {})
    unknown = set(opts) - set(TRAINER_OPTIONS)
    if unknown:
        raise ValueError(f"unknown Trainer options {sorted(unknown)}; known: {TRAINER_OPTIONS}")
    kw = {"autotune_budgets": opts.pop("autotune_budgets")} if "autotune_budgets" in opts else {}
    tr = Trainer(scene, Config(model=ModelConfig(), opt=ocfg), out_dir, rcfg=rcfg, device=dev,
                 **kw)
    for k, v in opts.items():
        setattr(tr, k, tuple(v) if k == "BLOCK_SIZES" else v)
    tr.save_intermediate = False
    return tr


def slots_lost(tr: Trainer) -> int:
    """The slots the run's steps lost, logged or not, summed: the trainer's
    counters of slots dropped past P and truncated past max_per_tile."""
    return tr.counters["dropped"] + tr.counters["truncated"]


def peak_start(dev) -> int | None:
    """Reset the card's peak-memory counter. -> the bytes allocated now
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def peak_mib(dev, base: int | None) -> float | None:
    """The run's own peak since `peak_start`: max_memory_allocated less what
    was allocated before the run, in MiB (None on the CPU)."""
    if base is None:
        return None
    torch.cuda.synchronize(dev)
    return round((torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20, 1)


def schedule(fast: bool) -> dict:
    """The iteration at which each stage ends and the densification window."""
    if fast:
        return dict(it0=60, it1=90, it21=120, it22=160, dense_until=40)
    return dict(it0=1400, it1=1900, it21=2200, it22=2600, dense_until=1100)


def opt_config(fast: bool, n_obj: int) -> OptimizationConfig:
    s = schedule(fast)
    return OptimizationConfig(
        iterations=s["it22"], start_ins_feat_iter=s["it0"], start_root_cb_iter=s["it1"],
        start_leaf_cb_iter=s["it21"], densify_from_iter=s["it0"] // 4,
        densify_until_iter=s["dense_until"], densification_interval=100,
        opacity_reset_interval=10 ** 6, densify_grad_threshold=0.0004,
        root_node_num=n_obj, leaf_node_num=2, sam_level=3,
        leaf_update_fr=max(s["it22"] // 20, 5))


def purity(cls_ids: np.ndarray, n_cls: int, alive: np.ndarray, obj_of: np.ndarray,
           n_obj: int) -> float:
    """The share of alive splats whose cluster's majority object is theirs,
    over the clusters of at least 3 splats."""
    cls = cls_ids[: len(alive)]
    tot = pure = 0
    for c in range(n_cls):
        m = alive & (cls == c)
        if m.sum() < 3:
            continue
        cnt = np.bincount(obj_of[m], minlength=n_obj)
        pure += cnt.max()
        tot += cnt.sum()
    return float(pure / max(tot, 1))


def text_queries(tr: Trainer, q: synthetic.QualityScene, lang: dict, obj_of: np.ndarray,
                 alive: np.ndarray) -> tuple[list, list, list]:
    """Each object's text query through the render_by_text path. -> (hit
    per object, silhouette IoU per (object, held-out view), diagnostics)."""
    n_obj, k2 = len(q.centers), tr.cfg.opt.leaf_node_num
    leaf_ids = tr.kms.leaf_cls_ids.cpu().numpy()[: len(alive)]
    leaf_centers = tr.kms.leaf_centers.cpu().numpy()
    means = tr.state.means.cpu().numpy()
    ones = torch.ones(3, device=tr.device)
    hits, ious, diag = [], [], []
    for oi in range(n_obj):
        sel = select_leaves_by_text(q.clip[oi + 1], lang, leaf_centers, k2)
        member = np.isin(leaf_ids, sel) & alive
        pts = means[member]
        if len(pts) >= 10:  # the KNN statistical outlier removal
            keep = statistical_outlier_mask(pts)
            idx = np.flatnonzero(member)
            member[idx[~keep]] = False
        comp = np.bincount(obj_of[member], minlength=n_obj)
        hits.append(bool(member.sum() >= 3 and comp.argmax() == oi))
        diag.append(dict(object=oi, selected_leaves=sel.tolist(), n_points=int(member.sum()),
                         composition=comp.tolist(),
                         occu=[float(lang["occu_count"][s]) for s in sel]))
        member_t = torch.as_tensor(member, device=tr.device)
        for tv, gt_m in zip(q.scene.test_views, q.test_masks):
            out = render_selection(tv.camera, tr.state, ones, member_t, q.rcfg)
            sil = out.cluster_silhouettes.cpu().numpy() > 0.7
            gt_sil = gt_m == oi
            ious.append(float((sil & gt_sil).sum() / max((sil | gt_sil).sum(), 1)))
    return hits, ious, diag


def run(fast: bool = False, device="cuda", trainer_options: dict | None = None,
        out: str | None = None) -> dict:
    """Build the scene, train every stage, score and write the result.
    trainer_options: any of TRAINER_OPTIONS, set on the Trainer (the
    Trainer's defaults for those not given). out: the
    directory of the JSON, the PNG and the model (a new temporary directory
    by default). -> the result, with `json` and `png` its files."""
    dev = resolve_device(device)
    out = out or tempfile.mkdtemp(prefix="quality_")
    os.makedirs(out, exist_ok=True)
    base = peak_start(dev)
    t_start = time.time()
    q = synthetic.quality_scene(synthetic.QUALITY_FAST if fast else synthetic.QUALITY_FULL, dev)
    n_obj = len(q.centers)
    s = schedule(fast)
    ocfg = opt_config(fast, n_obj)
    k1, k2 = ocfg.root_node_num, ocfg.leaf_node_num
    tr = make_trainer(q.scene, ocfg, os.path.join(out, "model"), q.rcfg, dev, trainer_options)
    print(f"[quality] init PSNR {tr.evaluate()['psnr']:.2f}", flush=True)

    tr.train(until=s["it0"], log_every=max(s["it0"] // 10, 10))
    m0 = tr.evaluate()
    print(f"[quality] stage-0 PSNR {m0['psnr']:.2f} pts {int(tr.state.num_alive)}", flush=True)
    tr.train(until=s["it22"], log_every=50)
    m_final = tr.evaluate()
    tr.run_stage3()

    alive = tr.state.alive.cpu().numpy()
    means = tr.state.means.cpu().numpy()
    obj_of = np.argmin(((means[:, None, :] - q.centers[None]) ** 2).sum(-1), axis=1)
    root_purity = purity(tr.kms.cls_ids.cpu().numpy(), k1, alive, obj_of, n_obj)
    leaf_purity = purity(tr.kms.leaf_cls_ids.cpu().numpy(), k1 * k2, alive, obj_of, n_obj)
    lang = dict(np.load(os.path.join(tr.out_dir, "cluster_lang.npz")))
    hits, ious, diag = text_queries(tr, q, lang, obj_of, alive)

    traj = [dict(iteration=h["iteration"], loss=h["loss"], root_id=h.get("root_id", -1))
            for h in tr.history if h["stage"] == "2.2"]
    per_root: dict[int, list] = {}
    for h in traj:
        per_root.setdefault(h["root_id"], []).append(h["loss"])
    root_loss = {str(r): dict(n=len(v), first=round(v[0], 4), last=round(v[-1], 4),
                              mean=round(float(np.mean(v)), 4))
                 for r, v in sorted(per_root.items())}
    img, _p, _l1 = eval_view(tr.state, tr.test_bundle, 0, tr.bg, tr.rcfg)
    size = q.size
    result = dict(
        workload=dict(width=size.width, height=size.height, n_train=len(q.scene.train_views),
                      n_test=len(q.scene.test_views), n_gt_splats=size.n_gt, objects=n_obj,
                      k1=k1, k2=k2, iters=s["it22"], fast=bool(fast)),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        stage0_psnr=round(float(m0["psnr"]), 3),
        final_psnr=round(float(m_final["psnr"]), 3),
        final_l1=round(float(m_final["l1"]), 5),
        num_alive=int(tr.state.num_alive),
        stage22_loss_trajectory=traj,
        stage22_per_root_loss=root_loss,
        root_cluster_purity=round(root_purity, 4),
        leaf_cluster_purity=round(leaf_purity, 4),
        text_retrieval_acc=round(float(np.mean(hits)), 3),
        text_query_miou=round(float(np.mean(ious)), 4),
        retrieval_diagnostics=diag,
        wall_s=round(time.time() - t_start, 1),
        peak_device_mib=peak_mib(dev, base),
        trainer_options=dict(autotune_budgets=tr.autotune_budgets,
                             use_frozen_plans=tr.use_frozen_plans,
                             BLOCK_SIZES=list(tr.BLOCK_SIZES)),
        slots_lost=slots_lost(tr),
    )
    path = os.path.join(out, "quality.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    from PIL import Image

    side = np.concatenate([img.cpu().numpy(), q.scene.test_views[0].gt_image], axis=1)
    png = os.path.join(out, "quality_side_by_side.png")
    Image.fromarray((np.clip(side, 0, 1) * 255).astype(np.uint8)).save(png)
    print(json.dumps(result, indent=1), flush=True)
    print(f"wrote {path} and {png}", flush=True)
    return dict(result, json=path, png=png)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fast", action="store_true", help="the CPU size (160x120, 160 iterations)")
    ap.add_argument("--out", default=None,
                    help="directory of quality.json, its PNG and the model "
                         "(default: a new temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(fast=args.fast, device=args.device, out=args.out)


if __name__ == "__main__":
    main()
