"""Per-stage training-step times of the port at the reference recipe's
scale, and the recipe's wall time projected from them (the port's
counterpart of the JAX repo's tools/stage_bench.py).

    python -m opengaussian_tpu_torch.tools.stage_bench [--iters 20] [--views 200]
        [--group-mode auto|scan|dense] [--scale 0.088] [--visible-frac 0.6] [--smoke]

The scene (`build_scene`, `build_bundle`: tools/stage_bench.py's, built in
numpy the same way, so equal bit for bit): 648x484 (ScanNet at -r 2), 200k
splats of which `--visible-frac` lie in the frustum and the rest behind the
camera, 64 spatially coherent roots (4x4x4 coordinate-quantile boxes) of 5
depth-slab leaves each, near-constant features per leaf, a codebook
consistent with them, one view with a random GT image and blocky SAM ids.
The budgets are `tuned_config(headroom=1.3)` and, unless `--group-mode
dense`, `tuned_group_config`. Before any timing, the renders the steps
make are held against their plain versions on the CPU at the smoke size
(`check_kernels`): stage 0's, stage 2.1's, stage 2.2's cluster render over
several roots (under `--group-mode dense` the K5/K6 group entries), and
the last two through a frozen plan.

Timed, each by CUDA events after one warm-up call, with each step's state
and moments fed to the next (so that no two steps see the same inputs):
the steps of stages 0, 1, 2.1 and 2.2 (train/loop.py), the same through a
frozen plan of the view (`frozen_plan_build_ms`, `frozen_plan_lost`,
`stage{1,21,22}_frozen_ms`), the root and leaf k-means, and sweep 1, sweep 2
and the stage-3 association of the view. `recipe_projection` turns them into
the minutes of the reference's ScanNet recipe (stages 1 to 3 over 60k
iterations, the sweeps over `--views` views) against its 20-minute anchor.

Prints one JSON line last, with every key of the JAX tool and `device`, the
card's name and power limit; comments go to standard error. --smoke runs
4,000 splats at 160x120 for 2 iterations (a plumbing check, not a
measurement; the tests run it on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.config import OptimizationConfig
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models import gaussians as G
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops import kmeans as km
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, build_frozen_plan
from opengaussian_tpu_torch.render import render, render_clusters
from opengaussian_tpu_torch.tools import bench, timing
from opengaussian_tpu_torch.train import losses
from opengaussian_tpu_torch.train import loop as L
from opengaussian_tpu_torch.train.lang import _associate_view
from opengaussian_tpu_torch.train.pseudo import _sweep1_view, _sweep2_view

K1, K2 = 64, 5
WIDTH, HEIGHT = 648, 484
N_GAUSS = 200_000
MAX_MASKS = 32
SMOKE = (4000, 160, 120)  # --smoke: splats, width, height; the kernel check's size
CHECK_ROOTS = 4  # the kernel check's cluster render: its roots
ANCHOR_MIN = 20.0  # the reference recipe's wall time (scripts/train_scannet.sh)
RECIPE_ITERS = 20_000  # iterations of each of stages 1, 2.1 and 2.2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def quantile_ids(x: np.ndarray, q: int) -> np.ndarray:
    """Equal-count bucket index 0..q-1 by value quantiles."""
    order = np.argsort(x, kind="stable")
    ids = np.empty_like(order)
    ids[order] = (np.arange(len(x)) * q) // len(x)
    return ids.astype(np.int32)


def build_scene(seed: int = 0, scale: float = 0.088, visible_frac: float = 0.6,
                device="cuda", n: int = N_GAUSS, width: int = WIDTH, height: int = HEIGHT):
    """tools/stage_bench.py:build_scene in the port, n splats at width x
    height -> (state, kms, cam, rng). visible_frac of the splats lie in the
    frustum, the rest behind the camera, spread across every cluster."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 1.2, n), rng.normal(0, 0.9, n),
                    rng.uniform(2.0, 10.0, n)], -1).astype(np.float32)
    hidden = rng.uniform(size=n) >= visible_frac
    pts[hidden, 2] = -pts[hidden, 2]
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    state = G.create_from_pcd(pts, cols, capacity=n, seed=seed, device="cpu")

    # 4x4x4 coordinate-quantile boxes -> 64 roots; 5 depth slabs each -> leaves
    bx = quantile_ids(pts[:, 0], 4)
    by = quantile_ids(pts[:, 1], 4)
    bz = quantile_ids(pts[:, 2], 4)
    cls_ids = (bx * 16 + by * 4 + bz).astype(np.int32)
    leaf_sub = np.zeros(n, np.int32)
    for r in range(K1):
        m = cls_ids == r
        leaf_sub[m] = quantile_ids(pts[m, 2] + 0.31 * pts[m, 1], K2)
    leaf_ids = cls_ids * K2 + leaf_sub

    leaf_feat = rng.uniform(-1, 1, (K1 * K2, 6)).astype(np.float32)
    feat = leaf_feat[leaf_ids] + rng.normal(0, 0.03, (n, 6)).astype(np.float32)
    opac = rng.normal(0.0, 2.0, n).astype(np.float32)
    state = dataclasses.replace(
        state, log_scales=state.log_scales + np.float32(np.log(scale)),
        logit_opacity=torch.as_tensor(opac), ins_feat=torch.as_tensor(feat))
    state = G.GaussianState(**{f.name: getattr(state, f.name).to(dev)
                               for f in dataclasses.fields(state)})

    root_centers = np.zeros((K1, 9), np.float32)
    feat9 = np.concatenate([feat, pts * 0.3], axis=-1)
    for r in range(K1):
        root_centers[r] = feat9[cls_ids == r].mean(axis=0)
    leaf_centers = np.zeros((K1 * K2 + 1, 6), np.float32)
    for leaf in range(K1 * K2):
        m = leaf_ids == leaf
        if m.any():
            leaf_centers[leaf] = feat[m].mean(axis=0)
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    kms = km.KMeansState(centers=t(root_centers), cls_ids=t(cls_ids),
                         leaf_centers=t(leaf_centers), leaf_cls_ids=t(leaf_ids),
                         leaf_sub_num=torch.full((K1,), K2, dtype=torch.int32, device=dev))
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 1.1, 0.9, width, height, device=dev)
    return state, kms, cam, rng


def build_bundle(rng, device="cuda", width: int = WIDTH, height: int = HEIGHT) -> L.ViewBundle:
    """tools/stage_bench.py:build_bundle at width x height: one view, a
    random GT image and an 8x4 grid of SAM ids 1..32 with an invalid border
    of 8 rows."""
    dev = torch.device(device)
    W, H = width, height
    gt = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    sam = (1 + (yy * 4 // H) * 8 + (xx * 8 // W)).astype(np.int32)
    sam[:8] = 0
    f = W / (2 * np.tan(1.1 / 2))
    fy = H / (2 * np.tan(0.9 / 2))

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    return L.ViewBundle(
        R=t(np.eye(3, dtype=np.float32)[None]), t=t(np.zeros((1, 3), np.float32)),
        fx=t([f]), fy=t([fy]), cx=t([(W - 1) / 2.0]), cy=t([(H - 1) / 2.0]),
        gt_images=t(gt), alpha_masks=torch.ones((1, H, W), device=dev),
        has_alpha=torch.zeros((1,), dtype=torch.bool, device=dev),
        sam_ids=t(sam[None], torch.int32), width=W, height=H, max_masks=MAX_MASKS)


def budgets(state, kms, cam, group_mode: str) -> RasterizeConfig:
    """The steps' budgets: tuned_config(headroom=1.3) on the view, the group
    render `group_mode` ("auto": the config's own), and tuned_group_config
    unless the group render is dense."""
    rcfg = budget.tuned_config(RasterizeConfig(max_per_tile=1024, chunk=64), state, [cam],
                               headroom=1.3)
    if group_mode != "auto":
        rcfg = dataclasses.replace(rcfg, group_render=group_mode)
    if rcfg.group_render != "dense":
        rcfg = budget.tuned_group_config(rcfg, state, [cam], kms.cls_ids, K1, headroom=1.3)
    return rcfg


def check_kernels(group_mode: str, scale: float, visible_frac: float, device) -> float:
    """The stage steps' kernels on the card against their plain versions,
    before any timing (`bench.hold_against_plain`), on this scene at SMOKE's
    size with budgets tuned to it as main tunes them: stage 0's color render
    (the gradients by every parameter), stage 2.1's root-quantized feature
    render, and stage 2.2's cluster render of the leaf-quantized features
    over CHECK_ROOTS roots at once (the group entries that sweep 2 and stage
    3 run too), the two by ins_feat; and on the stream layout the feature
    and cluster renders again through a frozen plan of the view (one root),
    as the frozen steps render. Images at bench.IMG_TOL, gradients at
    bench.GRAD_TOL; the losses leave out the silhouette masks, which a
    threshold makes discrete. -> the largest error."""
    n, w, h = SMOKE
    st, kms, cam, rng = build_scene(scale=scale, visible_frac=visible_frac, device="cpu",
                                    n=n, width=w, height=h)
    rcfg = budgets(st, kms, cam, group_mode)
    pseudo = rng.uniform(0, 1, (h, w, 6)).astype(np.float32)
    roots = [int(r) for r in np.argsort(-np.bincount(kms.cls_ids.numpy(), minlength=K1),
                                        kind="stable")[:CHECK_ROOTS]]

    def run(dev):
        st, kms, cam, _ = build_scene(scale=scale, visible_frac=visible_frac, device=dev, n=n,
                                      width=w, height=h)
        pf, bg = torch.as_tensor(pseudo, device=dev), torch.zeros(3, device=dev)
        out = {}
        params = {k: v.detach().requires_grad_(True) for k, v in st.params().items()}
        r = render(cam, st.with_params(params), bg, 3, rcfg)
        grads = torch.autograd.grad(losses.rgb_loss(r.render, pf[..., :3], 0.2),
                                    list(params.values()), allow_unused=True)
        out["stage 0 image"] = r.render
        out.update({f"stage 0 d_{k}": torch.zeros_like(p) if g is None else g
                    for (k, p), g in zip(params.items(), grads)})
        plan = None
        if rcfg.pallas_input == "stream":
            plan = build_frozen_plan(cam, st.means, build_cov3d(st.scales, st.quats),
                                     st.opacity, rcfg)
        for tag, frozen, groups in (("", None, roots), (" frozen", plan, roots[:1])):
            if tag and plan is None:
                continue
            p = L._freeze_geometry(st.params())
            gs = st.with_params(p)
            q = km.quantize(kms, p["ins_feat"], "root")
            r = render(cam, gs, bg, 3, rcfg, render_color=False, render_feat_map=True,
                       quantized_feat=q, frozen=frozen)
            (g,) = torch.autograd.grad(losses.l1_loss(r.ins_feat, pf), [p["ins_feat"]])
            out[f"stage 2.1{tag} features"], out[f"stage 2.1{tag} d_ins_feat"] = r.ins_feat, g
            q = km.quantize(kms, p["ins_feat"], "leaf")
            r = render_clusters(cam, gs, bg, kms.cls_ids, groups, rcfg, quantized_feat=q,
                                min_points=1, frozen=frozen)
            (g,) = torch.autograd.grad(losses.l2_loss(r.cluster_imgs, pf), [p["ins_feat"]])
            out[f"stage 2.2{tag} clusters"] = r.cluster_imgs
            out[f"stage 2.2{tag} d_ins_feat"] = g
        return out

    return bench.hold_against_plain(
        f"stage kernel check ({w}x{h}, {n} splats, group render {rcfg.group_render})", run,
        device, bench.GRAD_TOL,
        {k: bench.IMG_TOL for k in ("stage 0 image", "stage 2.1 features",
                                    "stage 2.2 clusters", "stage 2.1 frozen features",
                                    "stage 2.2 frozen clusters")})


def recipe_projection(res: dict, views: int) -> dict:
    """The reference ScanNet recipe's minutes from the measured ms (stages
    1, 2.1 and 2.2 of RECIPE_ITERS steps each, assign_root every 200 steps
    of 2.1, assign_leaf every 50 of 2.2; sweep 1 at the 2.1 entry, sweeps 1
    and 2 at the 2.2 entry and sweep 1 with the association at stage 3,
    each over `views` views). A frozen step counts where the plan lost
    nothing (stage 2.2: the faster of the two). -> the recipe_* keys,
    anchor_total_min and vs_anchor."""
    froz_ok = res.get("frozen_plan_lost", 1) == 0
    t1 = res["stage1_frozen_ms"] if froz_ok and "stage1_frozen_ms" in res \
        else res["stage1_step_ms"]
    t21_s = res["stage21_frozen_ms"] if froz_ok and "stage21_frozen_ms" in res \
        else res["stage21_step_ms"]
    t21 = t21_s + res["assign_root_ms"] / 200.0
    t22_s = min(res["stage22_step_ms"], res.get("stage22_frozen_ms", res["stage22_step_ms"])) \
        if froz_ok else res["stage22_step_ms"]
    t22 = t22_s + res["assign_leaf_ms"] / 50.0
    sweeps = (2 * res["sweep1_view_ms"] + res["sweep2_view_ms"]) * views
    stage3 = (res["sweep1_view_ms"] + res["lang_view_ms"]) * views
    total_ms = RECIPE_ITERS * (t1 + t21 + t22) + sweeps + stage3
    return dict(
        recipe_views_assumed=views,
        recipe_stage1_min=round(RECIPE_ITERS * t1 / 60e3, 2),
        recipe_stage21_min=round(RECIPE_ITERS * t21 / 60e3, 2),
        recipe_stage22_min=round(RECIPE_ITERS * t22 / 60e3, 2),
        recipe_sweeps_min=round(sweeps / 60e3, 2),
        recipe_stage3_min=round(stage3 / 60e3, 2),
        recipe_total_min=round(total_ms / 60e3, 2),
        anchor_total_min=ANCHOR_MIN,
        vs_anchor=round(ANCHOR_MIN / (total_ms / 60e3), 3))


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--views", type=int, default=200,
                    help="train-view count assumed by the recipe projection")
    ap.add_argument("--group-mode", choices=["auto", "scan", "dense"], default="auto")
    ap.add_argument("--scale", type=float, default=0.088)
    ap.add_argument("--visible-frac", type=float, default=0.6)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny plumbing check (not a measurement)")
    args = ap.parse_args(argv)
    n, w, h = SMOKE if args.smoke else (N_GAUSS, WIDTH, HEIGHT)
    if args.smoke:
        args.iters = 2
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    check_kernels(args.group_mode, args.scale, args.visible_frac, dev)
    state, kms, cam, rng = build_scene(scale=args.scale, visible_frac=args.visible_frac,
                                       device=dev, n=n, width=w, height=h)
    bundle = build_bundle(rng, dev, w, h)
    ocfg = OptimizationConfig(root_node_num=K1, leaf_node_num=K2)
    rcfg = budgets(state, kms, cam, args.group_mode)
    log(f"# budgets P={rcfg.max_intersections(n)} K={rcfg.max_per_tile} "
        f"groupP={rcfg.group_intersection_budget} groupK={rcfg.group_max_per_tile} [{card}]")

    adam = opt_mod.init(state.params())
    stats = G.DensifyStats.zeros(state.capacity, dev)
    bg = torch.zeros(3, device=dev)
    pseudo_feat = torch.as_tensor(rng.uniform(0, 1, (h, w, 6)).astype(np.float32),
                                  device=dev)
    res: dict = {}
    carry = {"state": state, "adam": adam}

    def timed(name, fn, chained: bool = False, iters=None):
        """ms per call of fn: chained, fn(state, adam) -> (state, adam, ...)
        and each call takes the last's outputs; else fn()."""
        def call():
            if chained:
                out = fn(carry["state"], carry["adam"])
                carry["state"], carry["adam"] = out[0], out[1]
            else:
                fn()

        res[name] = round(timing.step_ms(call, iters or args.iters, dev), 2)
        log(f"# {name}: {res[name]:.2f} ms")

    timed("stage0_step_ms", lambda s, a: L.stage0_step(s, a, stats, bundle, 0, 1000, bg, 1.0,
                                                       rcfg, ocfg), chained=True)
    timed("stage1_step_ms", lambda s, a: L.stage1_step(s, a, bundle, 0, 31_000, bg, 1.0, rcfg,
                                                       ocfg), chained=True)
    timed("stage21_step_ms", lambda s, a: L.stage21_step(s, a, kms, bundle, 0, 51_000, bg, 1.0,
                                                         pseudo_feat, rcfg, ocfg), chained=True)
    timed("stage22_step_ms", lambda s, a: L.stage22_step(s, a, kms, bundle, 0, 71_000, bg, 1.0,
                                                         pseudo_feat, 3, True, rcfg, ocfg),
          chained=True)

    if rcfg.pallas_input == "stream":
        st = carry["state"]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = build_frozen_plan(cam, st.means, build_cov3d(st.scales, st.quats), st.opacity,
                                 rcfg)
        res["frozen_plan_lost"] = int(plan.n_dropped) + int(plan.n_truncated)  # syncs
        res["frozen_plan_build_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        timed("stage1_frozen_ms", lambda s, a: L.stage1_step(
            s, a, bundle, 0, 31_000, bg, 1.0, rcfg, ocfg, False, plan), chained=True)
        timed("stage21_frozen_ms", lambda s, a: L.stage21_step(
            s, a, kms, bundle, 0, 51_000, bg, 1.0, pseudo_feat, rcfg, ocfg, False, plan),
            chained=True)
        timed("stage22_frozen_ms", lambda s, a: L.stage22_step(
            s, a, kms, bundle, 0, 71_000, bg, 1.0, pseudo_feat, 3, True, rcfg, ocfg, False,
            plan), chained=True)

    st = carry["state"]
    gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
    few = max(3, args.iters // 4)
    timed("assign_root_ms", lambda: km.assign_root(kms, st.ins_feat, st.means, st.alive, 0.3,
                                                   gen()), iters=few)
    timed("assign_leaf_ms", lambda: km.assign_leaf(kms, st.ins_feat, st.alive, 3, K2, gen()),
          iters=few)
    sam0 = bundle.sam_ids[0]
    timed("sweep1_view_ms", lambda: _sweep1_view(st, cam, sam0, bg, MAX_MASKS, rcfg),
          iters=max(3, args.iters // 2))
    timed("sweep2_view_ms", lambda: _sweep2_view(st, cam, pseudo_feat, sam0, kms.cls_ids, bg,
                                                 MAX_MASKS, K1, rcfg), iters=3)
    timed("lang_view_ms", lambda: _associate_view(
        st, kms.leaf_cls_ids, cam, pseudo_feat, sam0, torch.ones(K1, dtype=torch.bool,
                                                                 device=dev),
        bg, K1, K2, MAX_MASKS, rcfg), iters=3)

    res.update(recipe_projection(res, args.views))
    res["group_mode"] = rcfg.group_render
    res["device"] = card
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
