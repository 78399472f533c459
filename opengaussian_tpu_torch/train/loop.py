"""Training loop, stages 0 to 3.

Port of opengaussian_tpu/train/loop.py (reference train.py:157-635):
  * stage 0 (3DGS pretraining): one step renders the color pass with the
    screen tap, takes the L1 + SSIM loss, differentiates it, applies Adam and
    accumulates the densification statistics; densification and the opacity
    reset run between steps;
  * stage 1 (instance features): the feature pass of the frozen geometry
    against the view's SAM masks, with the cohesion and separation losses;
  * stage 2.1 (coarse codebook): pseudo labels from sweep 1 at entry, the
    root k-means every 200 iterations, and an L1 loss of the quantized
    feature render against the view's pseudo features;
  * stage 2.2 (leaf codebook): sweeps 1 and 2 at entry (sweep 2 sets each
    root's active leaf count and its per-view visibility), the leaf k-means
    of the current root at entry and every 50 iterations, the roots in
    round robin (the next every leaf_update_fr iterations), and an L2 loss
    of the current root's leaf-quantized cluster render against the pseudo
    features, skipped where the root does not occur in the view;
  * stage 3 (`Trainer.run_stage3`, after the last iteration): the language
    association of train/lang.py, which writes cluster_lang.npz.
Past stage 0 only ins_feat has a gradient; the geometry's learning rates are
zero, so it stays as it was, bit for bit. The blend's backward is K2 + K3
(ops/rasterize.py:StreamBlend), K4 + K3 with RasterizeConfig(bwd_layout=
"compact"), or, with RasterizeConfig(pallas_input="dense"), K6 + K3
(DenseBlend). Every view's ground truth and camera sits on the device in
stacked tensors (`ViewBundle`), or, with save_memory, in host memory, from
which each step copies its view's window to the device (`bundle_window`;
a lazily loaded scene decodes that view alone). With
enable_multiview_sam_refinement the SAM mask refiner (refine/sam_refiner.py)
rewrites the bundle's SAM ids once, before the first stage-1 step.
Checkpoints (`save_checkpoint`, `restore_checkpoint`) use
train/checkpoint.py.

By default a step is one eager Python function and the binning sizes the
slot stream per frame; the trainer then only raises max_per_tile past the
deepest tile it finds (`_fit_max_per_tile`), so that no slot is truncated.
The JAX trainer's options for fixed shapes are there, switched on one by
one under its names:
  * `Trainer(autotune_budgets=True)`: the budget probe of ops/budget.py
    fixes the slot budget P and max_per_tile (`_tune_budgets`), and the
    group budgets of the group renders at stage-2.1 and stage-2.2 entry
    (`_tune_group_budgets`); re-tuned after a capacity growth and after a
    logged step that lost slots;
  * `use_frozen_plans = True`: stages 1 and 2.1 take each view's binning
    from a cached FrozenPlan (`_ensure_frozen_plans`), stage 2.2 re-bins;
  * `BLOCK_SIZES = (50, 10, 5)` (with fixed budgets): runs of steps with no
    event between them go as one block (`_block_len`, `_run_block`). On a
    GPU each stage's step is a CUDA graph over static buffers, captured once
    and replayed for every step of the block with that step's view,
    iteration, learning rates, background, rescale factor and root written
    into a device buffer before the replay; on the CPU the same step runs
    eagerly. The counterpart of the JAX package's scanned stage*_block.
What the port leaves out so far raises NotImplementedError: the device mesh.

Observability as in the JAX trainer: the train_process/ PNG dumps
(train/observe.py, every 1000 iterations, 100 in stage 2.2, unless
`save_intermediate` is False), TensorBoard scalars and image grids where
tensorboard is installed, and the SIBR remote viewer
(viewer/network_gui.py) when `viewer_port` is set, polled at the top of
every loop turn.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.config import Config, OptimizationConfig
from opengaussian_tpu_torch.data.dataset import Scene, View
from opengaussian_tpu_torch.data.lazy import LazyStack, is_lazy
from opengaussian_tpu_torch.data.ply import save_gaussian_ply
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models import gaussians as G
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops import kmeans as km
from opengaussian_tpu_torch.ops import rasterize_kernels as rk
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import (
    FrozenPlan,
    RasterizeConfig,
    build_frozen_plan,
    deepest_tile,
    stack_plans,
)
from opengaussian_tpu_torch.refine.introspect import RefinerTrace
from opengaussian_tpu_torch.refine.sam_refiner import refine_sam_masks
from opengaussian_tpu_torch.render import render, render_clusters
from opengaussian_tpu_torch.train import checkpoint as ckpt
from opengaussian_tpu_torch.train import lang, losses, observe
from opengaussian_tpu_torch.train import pseudo as pseudo_mod
from opengaussian_tpu_torch.utils import codebook as cb
from opengaussian_tpu_torch.utils import masks as masku
from opengaussian_tpu_torch.viewer import network_gui

HEADROOM = budget.HEADROOM


def _at(x: torch.Tensor, i):
    """x[i] for an int i, or for a 1-element int64 tensor on x's device (the
    view index of a captured step, read at replay)."""
    return x.index_select(0, i)[0] if isinstance(i, torch.Tensor) else x[i]


@dataclasses.dataclass(frozen=True)
class StepHyper:
    """The per-step numbers a captured step reads from device memory: the
    learning rates (0-d tensors by leaf), Adam's bias corrections
    (`optimizer.bias_tensors`) and, in stage 0, the SH mask of the
    iteration [S] (1.0 for an active coefficient)."""

    lrs: dict
    bias: dict
    sh_mask: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class ViewBundle:
    """Every training view, stacked on one device, or in host memory
    (`bundle_views(..., host=True)`), where a lazily loaded scene's images,
    alpha masks and SAM ids are data/lazy.LazyStack stacks."""

    R: torch.Tensor  # [V,3,3]
    t: torch.Tensor  # [V,3]
    fx: torch.Tensor  # [V]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    gt_images: torch.Tensor  # [V,H,W,3]
    alpha_masks: torch.Tensor  # [V,H,W] (1.0 where no mask given)
    has_alpha: torch.Tensor  # [V] bool
    sam_ids: torch.Tensor  # [V,H,W] int32 (0 = no sidecar / invalid)
    width: int
    height: int
    max_masks: int

    def camera(self, i) -> Camera:
        """View i's camera; i an int or a 1-element int64 tensor (`_at`)."""
        return Camera(R_w2c=_at(self.R, i), t_w2c=_at(self.t, i), fx=_at(self.fx, i),
                      fy=_at(self.fy, i), cx=_at(self.cx, i), cy=_at(self.cy, i),
                      width=self.width, height=self.height)

    @property
    def num_views(self) -> int:
        return self.gt_images.shape[0]


def _host_tensor(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """x in host memory, pinned when `dev` is a GPU, so that its copies to
    the card can be asynchronous."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if dev.type == "cuda" else t


def bundle_views(views: list[View], sam_level: int, device="cuda",
                 host: bool = False) -> ViewBundle:
    """Stack `views` for training on `device`. host=False: every array on
    the device (the JAX package's device-resident bundle). host=True, the
    save_memory mode: the images, alpha masks and SAM ids stay in host memory
    (pinned when `device` is a GPU) and the trainer copies one view's window
    to the device per step (`bundle_window`; the reference's --save_memory
    to_gpu/to_cpu shuffling, scene/cameras.py:94-107). A lazily loaded
    scene (data/lazy.py) needs host=True: its stacks stay lazy, so host
    memory holds one decoded view, and a full-stack read (the SAM refiner)
    decodes them all at a transient peak."""
    if not views:
        raise ValueError("no views")
    dev = resolve_device(device)
    h, w = views[0].gt_image.shape[:2]
    for v in views:
        if v.gt_image.shape[:2] != (h, w):
            raise ValueError("views must share a resolution")
    lazy = any(is_lazy(v.gt_image) for v in views)
    if lazy and not host:
        raise ValueError("lazily loaded views need a host-resident bundle (save_memory)")

    def ids_of(v):
        if v.sam_mask is None:
            return np.zeros((h, w), np.int32)
        return masku.decode_sam_level(np.asarray(v.sam_mask), sam_level).astype(np.int32)

    ids = []
    max_masks = 8
    for v in views:
        m = ids_of(v)  # lazy views decode here once (streaming: not retained)
        max_masks = max(max_masks, int(m.max()))
        if not lazy:
            ids.append(m)
    max_masks = int(np.ceil(max_masks / 8) * 8)

    small_dev = torch.device("cpu") if host else dev

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype), device=small_dev)

    def big(x, dtype=np.float32):
        return _host_tensor(np.asarray(x, dtype), dev) if host else t(x, dtype)

    def alpha_of(v):
        if v.gt_alpha_mask is None:
            return np.ones((h, w), np.float32)
        return np.asarray(v.gt_alpha_mask, np.float32)

    if lazy:
        gt_images = LazyStack([lambda v=v: np.asarray(v.gt_image, np.float32)
                               for v in views], (h, w, 3), np.float32)
        alpha_masks = LazyStack([lambda v=v: alpha_of(v) for v in views], (h, w),
                                np.float32)
        sam_ids = LazyStack([lambda v=v: ids_of(v) for v in views], (h, w), np.int32)
    else:
        gt_images = big(np.stack([np.asarray(v.gt_image, np.float32) for v in views]))
        alpha_masks = big(np.stack([alpha_of(v) for v in views]))
        sam_ids = big(np.stack(ids), np.int32)
    return ViewBundle(
        R=t(np.stack([v.camera.R_w2c.cpu().numpy() for v in views])),
        t=t(np.stack([v.camera.t_w2c.cpu().numpy() for v in views])),
        fx=t([float(v.camera.fx) for v in views]),
        fy=t([float(v.camera.fy) for v in views]),
        cx=t([float(v.camera.cx) for v in views]),
        cy=t([float(v.camera.cy) for v in views]),
        gt_images=gt_images, alpha_masks=alpha_masks,
        has_alpha=t([v.gt_alpha_mask is not None for v in views], bool),
        sam_ids=sam_ids, width=w, height=h, max_masks=max_masks,
    )


def bundle_window(bundle: ViewBundle, vi: int, device) -> ViewBundle:
    """View vi of a host-resident bundle as a one-view bundle on `device`
    (the save_memory mode's per-step window, the JAX package's
    bundle_window). Pinned arrays copy asynchronously; a lazy stack decodes
    that view alone."""
    dev = resolve_device(device)

    def sl(x):
        x = x[vi:vi + 1]
        if not isinstance(x, torch.Tensor):  # a LazyStack's decoded view
            x = torch.from_numpy(x)
        return x.to(dev, non_blocking=True)

    return ViewBundle(
        R=sl(bundle.R), t=sl(bundle.t), fx=sl(bundle.fx), fy=sl(bundle.fy),
        cx=sl(bundle.cx), cy=sl(bundle.cy), gt_images=sl(bundle.gt_images),
        alpha_masks=sl(bundle.alpha_masks), has_alpha=sl(bundle.has_alpha),
        sam_ids=sl(bundle.sam_ids), width=bundle.width, height=bundle.height,
        max_masks=bundle.max_masks)


def _sh_active(iteration: int) -> int:
    """SH coefficients in use at `iteration`, the DC one included: the degree
    rises every 1000 iterations (reference train.py:255-256)."""
    return (min(iteration // 1000, 3) + 1) ** 2


def sh_mask_values(iteration: int, n_rest: int) -> list[float]:
    """The SH mask of `iteration`: 1.0 for each of the n_rest higher-order
    coefficients in use, else 0.0."""
    return [1.0 if i + 1 < _sh_active(iteration) else 0.0 for i in range(n_rest)]


def _mask_sh(gs: G.GaussianState, iteration: int, mask=None) -> G.GaussianState:
    """SH-degree warmup: inactive coefficients are multiplied by 0, which also
    blocks their gradients, as rendering at a lower degree would. mask: the
    iteration's mask as a device tensor (a captured step's)."""
    if mask is None:
        idx = torch.arange(gs.sh_rest.shape[1], device=gs.device) + 1
        mask = (idx < _sh_active(iteration)).to(gs.sh_rest.dtype)
    return dataclasses.replace(gs, sh_rest=gs.sh_rest * mask[None, :, None])


def stage0_step(state: G.GaussianState, adam: opt_mod.AdamState, stats: G.DensifyStats,
                bundle: ViewBundle, view_idx: int, iteration: int, bg: torch.Tensor,
                spatial_lr_scale: float, rcfg: RasterizeConfig,
                ocfg: OptimizationConfig, hyper: StepHyper | None = None):
    """One stage-0 step (the JAX package's _stage0_body): render the color
    pass with the screen tap, loss, gradients, Adam, densify statistics.
    view_idx: an int, or a 1-element int64 tensor on the device; hyper: the
    iteration's learning rates, bias corrections and SH mask as device
    tensors (a captured step), else computed from `iteration`.
    -> (state, adam, stats, loss, psnr, n_lost), the last three 0-d tensors."""
    gt = _at(bundle.gt_images, view_idx)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params().items()}
    tap = torch.zeros((state.capacity, 2), device=state.device, requires_grad=True)
    gs = _mask_sh(state.with_params(params), iteration,
                  None if hyper is None else hyper.sh_mask)
    out = render(bundle.camera(view_idx), gs, bg, 3, rcfg, screen_tap=tap)
    loss = losses.rgb_loss(out.render, gt, ocfg.lambda_dssim)
    loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    leaves = list(params.values()) + [tap]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # ins_feat is not rendered by the color pass: its gradient is zero
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    p_grads = dict(zip(params, grads[:-1]))
    new_p, adam = _adam(state, p_grads, adam, ocfg, iteration, spatial_lr_scale, hyper)
    stats = stats.update(grads[-1], out.radii)
    with torch.no_grad():
        psnr = losses.psnr(out.render, gt)
    return (state.with_params(new_p), adam, stats, loss.detach(), psnr,
            out.n_lost)


def _freeze_geometry(params: dict) -> dict:
    """Every leaf but ins_feat detached; ins_feat a fresh leaf that requires
    grad (the JAX package's stop_gradient on the geometry)."""
    return {k: v.detach().requires_grad_(k == "ins_feat") for k, v in params.items()}


def _alpha_mask_loss(out_alpha, bundle: ViewBundle, view_idx):
    """Per-view gate: maskless views carry an all-ones placeholder that must
    not be regressed against (reference train.py:491 checks per camera)."""
    return torch.where(_at(bundle.has_alpha, view_idx),
                       ((out_alpha - _at(bundle.alpha_masks, view_idx)) ** 2).mean(), 0.0)


def _adam(state: G.GaussianState, grads: dict, adam: opt_mod.AdamState,
          ocfg: OptimizationConfig, iteration: int, spatial_lr_scale: float,
          hyper: StepHyper | None):
    """Adam with the iteration's learning rates: from `hyper` (device
    tensors) in a captured step, else from the schedule."""
    if hyper is None:
        lrs = opt_mod.learning_rates(ocfg, iteration, spatial_lr_scale)
        return opt_mod.apply(state.params(), grads, adam, lrs)
    return opt_mod.apply(state.params(), grads, adam, hyper.lrs, hyper.bias)


def _feature_update(state: G.GaussianState, adam: opt_mod.AdamState, params: dict, loss,
                    iteration: int, ocfg: OptimizationConfig, keep=None,
                    hyper: StepHyper | None = None):
    """Adam on every leaf with the gradient by ins_feat alone (the frozen
    leaves get zeros and learning rate 0, so they stay as they were). keep
    (a 0-d bool tensor): where False, the gradient is zero, but Adam still
    steps."""
    (g,) = torch.autograd.grad(loss, [params["ins_feat"]])
    if keep is not None:
        g = torch.where(keep, g, 0.0)
    grads = {k: g if k == "ins_feat" else torch.zeros_like(v) for k, v in params.items()}
    new_p, adam = _adam(state, grads, adam, ocfg, iteration, 1.0, hyper)
    return state.with_params(new_p), adam


def stage1_step(state: G.GaussianState, adam: opt_mod.AdamState, bundle: ViewBundle,
                view_idx, iteration: int, bg: torch.Tensor, rescale_factor,
                rcfg: RasterizeConfig, ocfg: OptimizationConfig,
                with_alpha_loss: bool = False, frozen: FrozenPlan | None = None,
                hyper: StepHyper | None = None):
    """One stage-1 step (the JAX package's _stage1_body): the feature pass of
    the frozen geometry, mask means inside the silhouette, separation +
    loss_weight * cohesion against the view's SAM masks. frozen: the view's
    FrozenPlan; view_idx, rescale_factor and hyper may be device tensors
    (see stage0_step). -> (state, adam, loss, n_lost), the last two 0-d
    tensors."""
    params = _freeze_geometry(state.params())
    out = render(bundle.camera(view_idx), state.with_params(params), bg, 3, rcfg,
                 render_color=with_alpha_loss, render_feat_map=True,
                 rescale_factor=rescale_factor, frozen=frozen)
    sil = (out.silhouette > 0.7).to(torch.float32)
    masks, valid = masku.masks_onehot(_at(bundle.sam_ids, view_idx), bundle.max_masks)
    means = masku.mask_feature_mean(out.ins_feat, masks, image_mask=sil)
    l_coh = losses.cohesion_loss(out.ins_feat, masks, valid, means)
    l_sep = losses.separation_loss(means, valid, iteration)
    loss = l_sep + ocfg.loss_weight * l_coh
    if with_alpha_loss:
        loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg, hyper=hyper)
    return state, adam, loss.detach(), out.n_lost


def stage21_step(state: G.GaussianState, adam: opt_mod.AdamState, kms: km.KMeansState,
                 bundle: ViewBundle, view_idx, iteration: int, bg: torch.Tensor,
                 rescale_factor, pseudo_feat: torch.Tensor, rcfg: RasterizeConfig,
                 ocfg: OptimizationConfig, with_alpha_loss: bool = False,
                 frozen: FrozenPlan | None = None, hyper: StepHyper | None = None):
    """One stage-2.1 step (the JAX package's _stage21_body; reference
    train.py:464-473): L1 of the rendered root-quantized features against
    the view's pseudo features, inside the rendered silhouette. frozen,
    view_idx, rescale_factor, hyper: as for stage1_step.
    -> (state, adam, loss, n_lost), the last two 0-d tensors."""
    params = _freeze_geometry(state.params())
    q = km.quantize(kms, params["ins_feat"], "root")
    out = render(bundle.camera(view_idx), state.with_params(params), bg, 3, rcfg,
                 render_color=with_alpha_loss, render_feat_map=True, quantized_feat=q,
                 rescale_factor=rescale_factor, frozen=frozen)
    keep = (out.silhouette > 0.7).to(torch.float32)[..., None]
    loss = losses.l1_loss(out.ins_feat, pseudo_feat, keep)
    if with_alpha_loss:
        loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg, hyper=hyper)
    return state, adam, loss.detach(), out.n_lost


def stage22_step(state: G.GaussianState, adam: opt_mod.AdamState, kms: km.KMeansState,
                 bundle: ViewBundle, view_idx, iteration: int, bg: torch.Tensor,
                 rescale_factor, pseudo_feat: torch.Tensor, root_id,
                 root_visible, rcfg: RasterizeConfig, ocfg: OptimizationConfig,
                 with_alpha_loss: bool = False, hyper: StepHyper | None = None):
    """One stage-2.2 step (the JAX package's _stage22_body; reference
    train.py:475-497): render the root cluster root_id alone with
    leaf-quantized features, L2 against the view's pseudo features inside
    the cluster's silhouette. Where the root does not occur in the render
    or root_visible (sweep 2's verdict for this view, a 0-d bool tensor or
    bool) is false, the loss and the gradient are zero, but Adam still
    steps. root_id: an int, or a 1-element int64 tensor on the device;
    view_idx, rescale_factor, hyper: as for stage1_step.
    -> (state, adam, loss, ok, n_lost), the last three 0-d tensors."""
    params = _freeze_geometry(state.params())
    q = km.quantize(kms, params["ins_feat"], "leaf")
    gs = state.with_params(params)
    cam = bundle.camera(view_idx)
    roots = root_id if isinstance(root_id, torch.Tensor) else [root_id]
    out = render_clusters(cam, gs, bg, kms.cls_ids, roots, rcfg, quantized_feat=q,
                          rescale_factor=rescale_factor, min_points=1)
    sil = (out.cluster_silhouettes[0] > 0.7).to(torch.float32)[..., None]
    ok = out.cluster_occur[0] & torch.as_tensor(root_visible, device=state.device)
    loss = losses.l2_loss(out.cluster_imgs[0], pseudo_feat, sil)
    n_lost = out.n_lost
    if with_alpha_loss:
        color = render(cam, gs, bg, 3, rcfg)
        loss = loss + _alpha_mask_loss(color.alpha, bundle, view_idx)
        n_lost = torch.maximum(n_lost, color.n_lost)
    loss = torch.where(ok, loss, 0.0)
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg, keep=ok,
                                  hyper=hyper)
    return state, adam, loss.detach(), ok, n_lost


@torch.no_grad()
def eval_view(state: G.GaussianState, bundle: ViewBundle, view_idx: int, bg,
              rcfg: RasterizeConfig):
    """-> (image clipped to [0, 1], psnr, l1) of one view."""
    out = render(bundle.camera(view_idx), state, bg, 3, rcfg)
    img = torch.clamp(out.render, 0.0, 1.0)
    gt = bundle.gt_images[view_idx]
    return img, losses.psnr(img, gt), losses.l1_loss(img, gt)


class Trainer:
    """Host-side trainer of every stage (the JAX package's Trainer).

    View order, the random background and the rescale factor of stages 1 to
    2.2 come from np.random.default_rng(seed), drawn in the JAX package's
    order (a block draws its n views first, then n backgrounds, then n
    rescale factors, as the JAX package's _run_block does), so both trainers
    visit the same views; the split noise of densification and the k-means++
    seeds come from a torch.Generator seeded with `seed` on the training
    device. autotune_budgets: fixed budgets from ops/budget.py (the JAX
    trainer's default; off here, where the stream is sized per frame)."""

    # Runs of steps with no event between them go as one block of one of
    # these lengths (the JAX trainer's menu); () = one step at a time. A
    # block needs fixed budgets (autotune_budgets).
    BLOCK_SIZES: tuple = ()

    def __init__(self, scene: Scene, cfg: Config, out_dir: str,
                 rcfg: RasterizeConfig | None = None, seed: int = 0,
                 device="cuda", mesh=None, autotune_budgets: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "training over a device mesh arrives with the port's multi-GPU slice")
        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cfg_args.json"), "w") as f:
            f.write(cfg.to_json())

        # sorted order is load-bearing for pseudo labels (reference train.py:673)
        self.train_views = sorted(scene.train_views, key=lambda v: v.image_name)
        # save_memory keeps the test views in host memory too
        self.save_memory = bool(cfg.opt.save_memory)
        self.bundle = bundle_views(self.train_views, cfg.opt.sam_level, self.device,
                                   host=self.save_memory)
        self.test_bundle = (
            bundle_views(sorted(scene.test_views, key=lambda v: v.image_name),
                         cfg.opt.sam_level, self.device, host=self.save_memory)
            if scene.test_views else None)
        self.rcfg = rcfg or RasterizeConfig()
        # the ceiling the budget probe tunes against, so that budgets can
        # grow back when the scene's load rises
        self._base_rcfg = self.rcfg
        self.autotune_budgets = autotune_budgets
        self._bg_host = np.full(3, 1.0 if cfg.model.white_background else 0.0, np.float32)
        self.bg = torch.tensor(self._bg_host, device=self.device)
        self.spatial_lr_scale = scene.cameras_extent

        self.state = G.create_from_pcd(
            np.asarray(scene.points, np.float32), np.asarray(scene.colors, np.float32),
            sh_degree=cfg.model.sh_degree, seed=seed, device=self.device)
        self.adam = opt_mod.init(self.state.params())
        self.stats = G.DensifyStats.zeros(self.state.capacity, self.device)
        self.kms = km.KMeansState.create(self.state.capacity, cfg.opt.root_node_num,
                                         cfg.opt.leaf_node_num, self.device)
        self.pseudo: pseudo_mod.PseudoLabels | None = None
        self.any_alpha = bool(self.bundle.has_alpha.any())
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.iteration = 0
        self.root_id = 0  # the root stage 2.2 trains, in round robin
        self._budgets_tuned = False
        # per-view FrozenPlans of stages 1 and 2.1, stacked [V, ...]: None =
        # not built, False = tried and off (a build lost slots, or the stack
        # would pass frozen_plan_bytes_cap)
        self.use_frozen_plans = False
        self._frozen_plans: FrozenPlan | None | bool = None
        self.frozen_plan_bytes_cap = 4 << 30
        self._captured: dict[str, _CapturedStep] = {}  # by stage, CUDA only
        self._view_queue: list[int] = []
        self._last_lost: torch.Tensor | None = None
        self._last_view = 0
        self.losses: list[torch.Tensor] = []  # every step's loss, on the device
        self.history: list[dict] = []
        # periodic PNG dumps of the training process (reference train.py:503
        # save_intermediate)
        self.save_intermediate = True
        # SIBR remote viewer (reference train.py:235-248): off unless a port
        # is given, as the reference keeps its init commented out
        self.viewer_port: int | None = None
        self.viewer = None  # the viewer/network_gui.ViewerServer, once listening
        # TensorBoard, like the reference's prepare_output_and_logger
        # (train.py:637-657, 956-993); history alone where it is missing
        self._tb_first_eval = True
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(out_dir)
        except Exception:
            print("Tensorboard not available: not logging progress")

    # -- helpers --

    def _next_view(self) -> int:
        if not self._view_queue:
            self._view_queue = list(self.rng.permutation(self.bundle.num_views))
        return int(self._view_queue.pop())

    def _stage(self, it: int) -> str:
        o = self.cfg.opt
        if it <= o.start_ins_feat_iter:
            return "0"
        if it <= o.start_root_cb_iter:
            return "1"
        if it <= o.start_leaf_cb_iter:
            return "2.1"
        return "2.2"

    def _bg_for(self, stage: str) -> torch.Tensor:
        if self.cfg.opt.random_background and stage == "0":
            return torch.as_tensor(self._bg_values(stage)).to(self.device, non_blocking=True)
        return self.bg

    def _bg_values(self, stage: str) -> np.ndarray:
        """The step's background on the host (a draw for a random one)."""
        if self.cfg.opt.random_background and stage == "0":
            return self.rng.random(3).astype(np.float32)
        return self._bg_host

    def _tune_budgets(self):
        """Size the budgets before the first step, after a capacity growth and
        after a logged step that lost slots. With autotune_budgets, the JAX
        trainer's probe (ops/budget.py:tuned_config against the base config)
        fixes P and max_per_tile (and, when the base config sets tile_windows,
        the window count and window_extra), and the group budgets are re-probed once
        the root assignment exists; a change drops the frozen plans and the
        captured steps. Without it, `_fit_max_per_tile`."""
        if not self.autotune_budgets:
            self._fit_max_per_tile()
            return
        cams = [self.bundle.camera(i) for i in range(self.bundle.num_views)]
        new = budget.tuned_config(self._base_rcfg, self.state, cams)
        if new != self.rcfg:
            n = self.state.capacity
            print(f"[budget] intersections {self.rcfg.max_intersections(n)}->"
                  f"{new.max_intersections(n)}, max_per_tile "
                  f"{self.rcfg.max_per_tile}->{new.max_per_tile}", flush=True)
            self._set_rcfg(new)
        if self.iteration + 1 > self.cfg.opt.start_root_cb_iter:
            self._tune_group_budgets()
        self._budgets_tuned = True

    def _tune_group_budgets(self):
        """Per-root budgets of the group renders (stage 2.2, sweep 2, stage 3)
        from a probe of the current root assignment (ops/budget.py:
        tuned_group_config): at stage-2.1 and stage-2.2 entry and with every
        frame re-tune. A no-op without autotune_budgets and under
        group_render="dense", whose union binning takes the frame budgets."""
        if not self.autotune_budgets or self.rcfg.group_render == "dense":
            return
        cams = [self.bundle.camera(i) for i in range(self.bundle.num_views)]
        new = budget.tuned_group_config(self.rcfg, self.state, cams, self.kms.cls_ids,
                                        self.cfg.opt.root_node_num)
        if new != self.rcfg:
            print(f"[budget] group budgets P={new.group_intersection_budget} "
                  f"K={new.group_max_per_tile}", flush=True)
            self.rcfg = new  # the frame's plans stand; the captured steps do not
            self._captured.clear()

    def _set_rcfg(self, rcfg: RasterizeConfig):
        """New frame budgets: the frozen plans and the captured steps were
        made for the old ones."""
        self.rcfg = rcfg
        self._frozen_plans = None
        self._captured.clear()

    def _fit_max_per_tile(self):
        """The per-tile cap of the stream sized per frame (no fixed budgets):
        over up to 4 evenly spaced views, find the deepest tile and raise
        max_per_tile to 1.3x of it (rounded up to the chunk) when the cap is
        lower, as the JAX trainer's probe raises it. Under tile windows
        (rcfg.tile_windows > 0) max_per_tile stays and the window count grows
        to cover that depth instead. Reading the deepest tile is a host sync
        per view. Runs where `_tune_budgets` runs."""
        V = self.bundle.num_views
        cov3d = build_cov3d(self.state.scales, self.state.quats)
        cnt = max(deepest_tile(self.bundle.camera(i), self.state.means, cov3d,
                               self.state.opacity, self.rcfg)
                  for i in list(range(0, V, max(1, V // 4)))[:4])
        chunk = self.rcfg.chunk
        k = -(-int(cnt * HEADROOM) // chunk) * chunk
        if self.rcfg.tile_windows > 0:
            s = -(-k // self.rcfg.max_per_tile)
            if s > self.rcfg.tile_windows:
                print(f"[budget] tile_windows {self.rcfg.tile_windows}->{s} "
                      f"(deepest tile {cnt})", flush=True)
                self.rcfg = dataclasses.replace(self.rcfg, tile_windows=s)
        elif k > self.rcfg.max_per_tile:
            print(f"[budget] max_per_tile {self.rcfg.max_per_tile}->{k} "
                  f"(deepest tile {cnt})", flush=True)
            self.rcfg = dataclasses.replace(self.rcfg, max_per_tile=k)
        self._budgets_tuned = True

    def _maybe_grow(self):
        """Double the capacity when more than 90% of the slots are alive. The
        geometry is about to change: any frozen plans are stale."""
        self._frozen_plans = None
        if int(self.state.num_alive) / self.state.capacity > 0.9:
            new_cap = G.round_capacity(int(self.state.capacity * 2))
            self.state = G.grow_capacity(self.state, new_cap)
            self.adam = opt_mod.AdamState(mu=G.grow_capacity(self.adam.mu, new_cap),
                                          nu=G.grow_capacity(self.adam.nu, new_cap),
                                          count=self.adam.count)
            self.stats = G.grow_capacity(self.stats, new_cap)
            self.kms = self.kms.grow(new_cap)
            self._budgets_tuned = False  # re-probe at the new scale
            self._captured.clear()

    def _rescale_factor(self, it: int) -> float:
        """50% chance of a uniform rescale once past start_root_cb_iter
        (reference gaussian_renderer/__init__.py:121-124, train.py:347-350)."""
        if it <= self.cfg.opt.start_root_cb_iter:
            return 1.0
        if self.rng.random() > 0.5:
            return float(self.rng.random())
        return 1.0

    def _ensure_frozen_plans(self) -> FrozenPlan | None:
        """The stacked per-view FrozenPlans of stages 1 and 2.1, built once
        (the JAX trainer's cache, loop.py:795): None when use_frozen_plans is
        off, off the stream layout, or when the cache was turned off because
        a build lost slots (a plan is exact only when lossless) or the stack
        would pass frozen_plan_bytes_cap."""
        if (not self.use_frozen_plans or self._frozen_plans is False
                or self.rcfg.pallas_input != "stream"):
            return None
        if self._frozen_plans is not None:
            return self._frozen_plans
        V = self.bundle.num_views
        n = self.state.capacity
        T = -(-self.bundle.width // 16) * -(-self.bundle.height // 16)
        est = V * 4 * (self.rcfg.max_intersections(n) + 2 * T)
        if est > self.frozen_plan_bytes_cap:
            print(f"[frozen] plans disabled: ~{est >> 20} MB exceeds the "
                  f"{self.frozen_plan_bytes_cap >> 20} MB cap", flush=True)
            self._frozen_plans = False
            return None
        cov3d = build_cov3d(self.state.scales, self.state.quats)
        t0 = time.time()
        plans = [build_frozen_plan(self.bundle.camera(vi), self.state.means, cov3d,
                                   self.state.opacity, self.rcfg) for vi in range(V)]
        lost = int(sum(p.n_dropped + p.n_truncated for p in plans))  # one host sync
        if lost > 0:
            print(f"[frozen] plans disabled: builds lost {lost} slots at the "
                  "current budgets (the plans would not be exact)", flush=True)
            self._frozen_plans = False
            return None
        self._frozen_plans = stack_plans(plans, n)
        print(f"[frozen] built {V} view plans in {time.time() - t0:.1f}s "
              f"({self._frozen_plans.nbytes() >> 20} MB)", flush=True)
        return self._frozen_plans

    def _ensure_pseudo(self, mode: str):
        o = self.cfg.opt
        cams = [self.bundle.camera(i) for i in range(self.bundle.num_views)]
        self.pseudo = pseudo_mod.construct_pseudo_labels(
            self.state, cams, self.bundle.sam_ids, self.bg, self.bundle.max_masks,
            self.rcfg, mode=mode, cls_ids=self.kms.cls_ids, k1=o.root_node_num,
            k2=o.leaf_node_num, to_host=self.save_memory)
        if mode == "leaf":
            self.kms = dataclasses.replace(self.kms, leaf_sub_num=self.pseudo.leaf_sub_num)

    def _pre_events(self, it: int, stage: str):
        """Events BEFORE step `it` (reference train.py:265-355, 393-426):
        the SAM mask refinement before the first stage-1 step; sweep 1 at
        stage-2.1 entry, and the root k-means there and every 200
        iterations; sweeps 1 and 2 at stage-2.2 entry, and the leaf k-means
        of the current root there and every 50 iterations."""
        o = self.cfg.opt
        if o.enable_multiview_sam_refinement and it == o.start_ins_feat_iter + 1:
            self.refine_sam_masks()
        if it == o.start_root_cb_iter + 1:
            self._ensure_pseudo("root")
        if it == o.start_leaf_cb_iter + 1:
            self._ensure_pseudo("leaf")
        if stage == "2.1" and (it % 200 == 1 or it == o.start_root_cb_iter + 1):
            self.kms = km.assign_root(
                self.kms, self.state.ins_feat, self.state.means, self.state.alive,
                o.pos_weight, self.generator, init=(it == o.start_root_cb_iter + 1))
            if it == o.start_root_cb_iter + 1:
                self._tune_group_budgets()  # the first real assignment
        elif stage == "2.2" and (it % 50 == 1 or it == o.start_leaf_cb_iter + 1):
            self.kms = km.assign_leaf(
                self.kms, self.state.ins_feat, self.state.alive, self.root_id,
                o.leaf_node_num, self.generator, init=(it == o.start_leaf_cb_iter + 1))
            if it == o.start_leaf_cb_iter + 1:
                self._tune_group_budgets()

    def _has_pre_event(self, it: int, stage: str) -> bool:
        o = self.cfg.opt
        if it in (o.start_ins_feat_iter + 1, o.start_root_cb_iter + 1,
                  o.start_leaf_cb_iter + 1):
            return True
        return (stage == "2.1" and it % 200 == 1) or (stage == "2.2" and it % 50 == 1)

    def _has_post_event(self, it: int, stage: str, until: int, log_every: int) -> bool:
        o = self.cfg.opt
        if it % log_every == 0 or it >= until:
            return True
        if stage == "0" and it < o.densify_until_iter and not o.frozen_init_pts:
            if it > o.densify_from_iter and it % o.densification_interval == 0:
                return True
            if it % o.opacity_reset_interval == 0 or (
                    self.cfg.model.white_background and it == o.densify_from_iter):
                return True
        return False

    def _block_len(self, it: int, stage: str, until: int, log_every: int) -> int:
        """The largest n of BLOCK_SIZES such that steps it..it+n-1 form one
        block: no pre event strictly inside, no post event but after the
        last step (the JAX trainer's rule). 1 under save_memory, whose steps
        each copy their view's window."""
        if not self.BLOCK_SIZES or self.save_memory:
            return 1
        limit = min(self.BLOCK_SIZES[0], until - it + 1)
        n = 1
        while n < limit:
            j = it + n
            if self._stage(j) != stage or self._has_pre_event(j, stage):
                break
            if self._has_post_event(j - 1, stage, until, log_every):
                break
            n += 1
        return next((b for b in self.BLOCK_SIZES if n >= b), 1)

    def _post_events(self, it: int, stage: str):
        """Densification / opacity reset AFTER step `it` (reference
        train.py:593-605)."""
        o = self.cfg.opt
        if stage != "0" or it >= o.densify_until_iter or o.frozen_init_pts:
            return
        if it > o.densify_from_iter and it % o.densification_interval == 0:
            self._maybe_grow()
            self.state, (mu, nu), self.stats, _ = G.densify_and_prune(
                self.state, (self.adam.mu, self.adam.nu), self.stats,
                o.densify_grad_threshold, 0.005, self.scene.cameras_extent,
                20.0 if it > o.opacity_reset_interval else 0.0, o.percent_dense,
                generator=self.generator)
            self.adam = opt_mod.AdamState(mu, nu, self.adam.count)
        if it % o.opacity_reset_interval == 0 or (
                self.cfg.model.white_background and it == o.densify_from_iter):
            self.state, (mu, nu) = G.reset_opacity(self.state, (self.adam.mu, self.adam.nu))
            self.adam = opt_mod.AdamState(mu, nu, self.adam.count)

    # -- main loop --

    def train(self, until: int | None = None, log_every: int = 200):
        o = self.cfg.opt
        until = until or o.iterations
        t_start = time.time()
        while self.iteration < until:
            if not self._budgets_tuned:
                self._tune_budgets()
            self._poll_viewer()
            it = self.iteration + 1
            stage = self._stage(it)
            if stage == "2.2" and (it - o.start_leaf_cb_iter) % o.leaf_update_fr == 0:
                self.root_id = (self.root_id + 1) % o.root_node_num
            self._pre_events(it, stage)
            n = self._block_len(it, stage, until, log_every)
            if n > 1:
                loss = self._run_block(it, stage, n)
            else:
                loss = self._run_single(it, stage)
                self.losses.append(loss)
            it = it + n - 1
            self.iteration = it
            self._post_events(it, stage)
            if self.save_intermediate and it % observe.dump_frequency(stage) == 0:
                observe.dump_intermediate(self, it, stage, self._last_view)
            if it % log_every == 0 or it >= until:
                lost = int(self._last_lost)
                if lost > 0:
                    print(f"[budget] WARNING: step {it} lost {lost} slots to "
                          f"max_per_tile={self.rcfg.max_per_tile}; re-probing",
                          flush=True)
                    self._budgets_tuned = False
                rec = dict(iteration=it, stage=stage, loss=float(loss),
                           num_alive=int(self.state.num_alive),
                           elapsed=time.time() - t_start)
                if stage == "2.2":  # one root per step: the loss reads per root
                    rec["root_id"] = self.root_id
                self.history.append(rec)
                if self.tb is not None:
                    self.tb.add_scalar("train_loss_patches/total_loss", rec["loss"], it)
                    self.tb.add_scalar("total_points", rec["num_alive"], it)
                    self.tb.add_scalar("iter_time", rec["elapsed"] / max(it, 1), it)
                print(f"[it {it}] stage {stage} loss {rec['loss']:.5f} "
                      f"pts {rec['num_alive']} ({rec['elapsed']:.0f}s)", flush=True)

    def _run_single(self, it: int, stage: str) -> torch.Tensor:
        o = self.cfg.opt
        vi = self._last_view = self._next_view()
        bg = self._bg_for(stage)
        bundle, svi = self.view(self.bundle, vi)
        if stage == "0":
            self.state, self.adam, self.stats, loss, _psnr, self._last_lost = stage0_step(
                self.state, self.adam, self.stats, bundle, svi, it, bg,
                self.spatial_lr_scale, self.rcfg, o)
        elif stage == "1":
            self.state, self.adam, loss, self._last_lost = stage1_step(
                self.state, self.adam, bundle, svi, it, bg, self._rescale_factor(it),
                self.rcfg, o, self.any_alpha, frozen=self._plan(vi))
        elif stage == "2.1":
            self.state, self.adam, loss, self._last_lost = stage21_step(
                self.state, self.adam, self.kms, bundle, svi, it, bg,
                self._rescale_factor(it), self._pseudo_feat(vi), self.rcfg, o,
                self.any_alpha, frozen=self._plan(vi))
        else:
            # stage 2.2 takes no frozen plan, as in the JAX trainer: the
            # single-root blend over the whole frozen stream walks more than
            # the per-root re-binning at the group budgets
            occur = self.pseudo.cluster_occur if self.pseudo is not None else None
            root_vis = occur[vi, self.root_id] if occur is not None else True
            self.state, self.adam, loss, _ok, self._last_lost = stage22_step(
                self.state, self.adam, self.kms, bundle, svi, it, bg,
                self._rescale_factor(it), self._pseudo_feat(vi), self.root_id, root_vis,
                self.rcfg, o, self.any_alpha)
        return loss

    def _plan(self, vi: int) -> FrozenPlan | None:
        plans = self._ensure_frozen_plans()
        return None if plans is None else plans.select(vi)

    def _run_block(self, it: int, stage: str, n: int) -> torch.Tensor:
        """Steps it..it+n-1 of one stage as a block (the JAX trainer's
        _run_block): the views are drawn first, then the backgrounds, then
        the rescale factors; stage 2.2's roots advance inside the block. Each
        step's numbers go into one row of a device buffer (`_step_row`), and
        the stage's step runs on static buffers (`_CapturedStep`): replayed
        as a CUDA graph on a GPU, run eagerly on the CPU. -> the last step's
        loss; every step's loss joins self.losses."""
        if not self.autotune_budgets or not self.rcfg.intersection_budget:
            raise ValueError("blocks of steps (BLOCK_SIZES) need fixed budgets: "
                             "Trainer(..., autotune_budgets=True)")
        o = self.cfg.opt
        vis = [self._next_view() for _ in range(n)]
        self._last_view = vis[-1]
        bgs = [self._bg_values(stage) for _ in range(n)]
        rescales = ([1.0] * n if stage == "0"
                    else [self._rescale_factor(j) for j in range(it, it + n)])
        roots, rid = [], self.root_id
        for j in range(it, it + n):
            if stage == "2.2" and j > it and (j - o.start_leaf_cb_iter) % o.leaf_update_fr == 0:
                rid = (rid + 1) % o.root_node_num
            roots.append(rid)
        self.root_id = rid
        frozen = self._ensure_frozen_plans() if stage in ("1", "2.1") else None
        rows = torch.stack([self._step_row(stage, it + j, vis[j], bgs[j], rescales[j],
                                           roots[j], self.adam.count + j + 1)
                            for j in range(n)])
        # one copy of the block's rows; the late-stage flag of the
        # separation loss is the one number a step takes as a constant
        rows = rows.to(self.device, non_blocking=True)
        lost = torch.zeros((), dtype=torch.int32, device=self.device)
        step, count = None, self.adam.count
        for j in range(n):
            late = it + j > losses.LATE_ITERATION
            if step is None or step.late != late:
                if step is not None:  # the block crosses the late iteration
                    step.copy_out(self, count + j)
                step = self._captured_step(stage, late, frozen)
            self.losses.append(step.run(rows[j]))
            lost = torch.maximum(lost, step.io["lost"])
        step.copy_out(self, count + n)
        self._last_lost = lost
        return self.losses[-1]

    def _step_row(self, stage: str, it: int, vi: int, bg, rescale: float, root: int,
                  count: int) -> torch.Tensor:
        """One step's numbers, as the float32 row (on the host) a captured
        step reads: view, root, rescale factor, background (3 host values),
        Adam's bias corrections for step `count` (4), the learning rates by
        leaf, the SH mask."""
        scale = self.spatial_lr_scale if stage == "0" else 1.0
        lrs = opt_mod.learning_rates(self.cfg.opt, it, scale)
        return torch.tensor([vi, root, rescale, *(float(x) for x in bg)]
                            + opt_mod.bias_values(count)
                            + [lrs[k] for k in self.state.params()]
                            + sh_mask_values(it, self.state.sh_rest.shape[1]),
                            dtype=torch.float32)

    def _captured_step(self, stage: str, late: bool,
                       frozen: FrozenPlan | None) -> "_CapturedStep":
        """The stage's step on static buffers with the current state copied
        in; on a GPU its graph, captured anew when what it was captured for
        has changed (a budget, the capacity, the views, the pseudo labels,
        the plans, the late flag)."""
        key = (late, self.rcfg, self.state.capacity, self.any_alpha, self.spatial_lr_scale)
        deps = (self.bundle, self.pseudo, frozen)
        step = self._captured.get(stage)
        if step is None or step.key != key or any(a is not b for a, b in zip(step.deps, deps)):
            self._captured.pop(stage, None)  # frees the old graph's memory first
            step = _CapturedStep(self, stage, late, frozen, key, deps)
            self._captured[stage] = step
        step.copy_in(self)
        return step

    def view(self, bundle: ViewBundle, i: int) -> tuple[ViewBundle, int]:
        """View i of `bundle` as (bundle, index) on the device: under
        save_memory its one-view window, copied from host memory."""
        if self.save_memory:
            return bundle_window(bundle, i, self.device), 0
        return bundle, i

    def _pseudo_feat(self, vi: int) -> torch.Tensor:
        """View vi's pseudo features on the device (a copy from host memory
        under save_memory)."""
        return self.pseudo.feat[vi].to(self.device, non_blocking=True)

    def refine_sam_masks(self):
        """One-shot cross-view SAM mask refinement (refine/sam_refiner.py);
        rewrites the bundle's SAM ids (void -1 becomes the invalid id 0) and
        raises max_masks to the refined ids, rounded up to a multiple of 8.
        With save_intermediate the refiner's trace writes refine_trace/ into
        the output directory."""
        print("Applying multi-view SAM mask refinement...", flush=True)
        cams = [self.bundle.camera(i) for i in range(self.bundle.num_views)]
        trace = RefinerTrace(self.out_dir) if self.save_intermediate else None
        sam = self.bundle.sam_ids
        sam = sam.cpu().numpy() if isinstance(sam, torch.Tensor) else np.asarray(sam)
        refined = refine_sam_masks(self.state, cams, sam, self.rcfg, trace=trace)
        ids = np.maximum(refined, 0).astype(np.int32)
        new_max = int(np.ceil(max(int(ids.max()), 8) / 8) * 8)
        ids = (_host_tensor(ids, self.device) if self.save_memory
               else torch.as_tensor(ids, device=self.device))
        self.bundle = dataclasses.replace(self.bundle, sam_ids=ids, max_masks=new_max)
        print("Multi-view SAM mask refinement completed", flush=True)

    def run_stage3(self) -> dict:
        """The language association (reference train.py:622-631) with the
        leaf codebook; writes cluster_lang.npz into the output directory.
        -> its arrays."""
        o = self.cfg.opt
        if self.pseudo is None or self.pseudo.cluster_occur is None:
            self._ensure_pseudo("leaf")
        tables = lang.clip_tables_from_views(self.train_views, o.sam_level)
        return lang.associate_language(
            self.state, self.kms, self.bundle, self.pseudo, tables, self.bg,
            o.root_node_num, o.leaf_node_num, self.rcfg,
            out_path=os.path.join(self.out_dir, "cluster_lang.npz"))

    # -- evaluation / artifacts --

    def evaluate(self, max_views: int = 25) -> dict:
        bundle = self.test_bundle or self.bundle
        n = min(bundle.num_views, max_views)
        psnrs, l1s, imgs, gts = [], [], [], []
        for i in range(n):
            b, j = self.view(bundle, i)
            img, p, l1 = eval_view(self.state, b, j, self.bg, self.rcfg)
            psnrs.append(float(p))
            l1s.append(float(l1))
            if len(imgs) < 5:
                imgs.append(img)
                gts.append(b.gt_images[j])
        m = dict(psnr=float(np.mean(psnrs)), l1=float(np.mean(l1s)), views=n)
        if self.tb is not None:
            split = "test" if self.test_bundle else "train"
            observe.tb_image_grids(self, imgs, gts, split, self._tb_first_eval)
            self._tb_first_eval = False
            self.tb.add_scalar(f"{split}/loss_viewpoint - psnr", m["psnr"], self.iteration)
            self.tb.add_scalar(f"{split}/loss_viewpoint - l1_loss", m["l1"], self.iteration)
            op = self.state.opacity[self.state.alive].cpu().numpy()
            self.tb.add_histogram("scene/opacity_histogram", op, self.iteration)
        return m

    # -- remote viewer (reference train.py:235-248) --

    def _poll_viewer(self):
        if self.viewer_port is None:
            return
        if self.viewer is None:
            self.viewer = network_gui.init("127.0.0.1", self.viewer_port)
        self.viewer.poll_and_render(self._viewer_render,
                                    self.cfg.model.source_path or self.out_dir)

    @torch.no_grad()
    def _viewer_render(self, cam: dict, scale_mod: float) -> bytes:
        """One viewer frame: the color pass through the viewer's camera (a
        w2c and fields of view), as uint8 H x W x 3 bytes."""
        w2c = np.asarray(cam["w2c"], np.float32)
        camera = Camera.from_fov(w2c[:3, :3], w2c[:3, 3], cam["fovx"], cam["fovy"],
                                 cam["width"], cam["height"], self.device)
        out = render(camera, self.state, self.bg, 3, self.rcfg,
                     scale_modifier=float(scale_mod))
        img = torch.clamp(out.render, 0.0, 1.0).cpu().numpy()
        return (img * 255).astype(np.uint8).tobytes()

    def save(self):
        """The PLY and, past start_root_cb_iter, the root codebook (centers and
        one id per alive splat), past start_leaf_cb_iter the leaf codebook,
        under point_cloud/iteration_<it>/."""
        o = self.cfg.opt
        pc_dir = os.path.join(self.out_dir, f"point_cloud/iteration_{self.iteration}")
        os.makedirs(pc_dir, exist_ok=True)
        save_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"), self.state)
        alive = self.state.alive.cpu().numpy()
        if self.iteration > o.start_root_cb_iter:
            cb.save_codebook(os.path.join(pc_dir, "root_code_book"),
                             self.kms.centers.cpu().numpy(),
                             self.kms.cls_ids.cpu().numpy()[alive])
        if self.iteration > o.start_leaf_cb_iter:
            cb.save_codebook(os.path.join(pc_dir, "leaf_code_book"),
                             self.kms.leaf_centers.cpu().numpy(),
                             self.kms.leaf_cls_ids.cpu().numpy()[alive])

    def save_checkpoint(self):
        """chkpnt<iteration>.npz in the output directory (train/checkpoint.py)."""
        ckpt.save(os.path.join(self.out_dir, f"chkpnt{self.iteration}.npz"), self.state,
                  self.adam, self.stats, self.kms, self.iteration)

    def restore_checkpoint(self, path: str):
        """Resume from a checkpoint of either package (.npz) or a reference
        chkpnt*.pth (scripts/train_scannet.sh:46-48)."""
        if path.endswith(".pth"):
            (self.state, self.adam, self.stats, self.iteration,
             self.spatial_lr_scale) = ckpt.load_torch(path, device=self.device)
        else:
            self.state, self.adam, self.stats, kms, self.iteration = ckpt.load(
                path, self.device)
            if kms is not None:
                self.kms = kms
        self._frozen_plans = None
        self._captured.clear()
        self.state = ckpt.ensure_ins_feat(self.state)
        if self.state.capacity != self.kms.cls_ids.shape[0]:
            o = self.cfg.opt
            self.kms = km.KMeansState.create(self.state.capacity, o.root_node_num,
                                             o.leaf_node_num, self.device)
        self._budgets_tuned = False


def _clone_state(state: G.GaussianState) -> G.GaussianState:
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


def _fields(x) -> list[torch.Tensor]:
    """The tensors of a dataclass (a GaussianState or DensifyStats)."""
    return [getattr(x, f.name) for f in dataclasses.fields(x)]


class _CapturedStep:
    """One stage's step on static buffers: the state, Adam's moments, the
    densification statistics, the k-means state and a row of per-step
    numbers (`Trainer._step_row`) live in tensors that stay put, and the step
    writes its results back into them. On a GPU the step is captured once as
    a torch.cuda.CUDAGraph (after one warm-up run on a side stream, which
    also builds the kernels and sets their attributes) and each `run`
    replays it; on the CPU each `run` calls it. A capture that fails raises.

    The graph reads the views, the pseudo labels and the frozen plans where
    they lie; its key (`Trainer._captured_step`) holds them, so that new ones
    make a new capture. A replay runs no Python, so each replay adds to the
    kernels' launch counters what the capture launched (the warm-up and the
    capture are not counted)."""

    def __init__(self, tr: "Trainer", stage: str, late: bool, frozen, key, deps):
        self.stage, self.late, self.frozen, self.key, self.deps = stage, late, frozen, key, deps
        self.tr = tr
        dev = tr.device
        n_rest = tr.state.sh_rest.shape[1]
        self.io = dict(
            row=torch.zeros(10 + len(tr.state.params()) + n_rest, device=dev),
            state=_clone_state(tr.state),
            mu={k: v.clone() for k, v in tr.adam.mu.items()},
            nu={k: v.clone() for k, v in tr.adam.nu.items()},
            stats=G.DensifyStats(*(x.clone() for x in _fields(tr.stats))),
            kms=dataclasses.replace(tr.kms, **{
                k: getattr(tr.kms, k).clone()
                for k in ("centers", "cls_ids", "leaf_centers", "leaf_cls_ids")}),
            loss=torch.zeros((), device=dev),
            lost=torch.zeros((), dtype=torch.int32, device=dev))
        self.graph = None
        self.deltas: dict = {}

    def copy_in(self, tr: "Trainer"):
        io = self.io
        for a, b in zip(_fields(io["state"]), _fields(tr.state)):
            a.copy_(b)
        for k in io["mu"]:
            io["mu"][k].copy_(tr.adam.mu[k])
            io["nu"][k].copy_(tr.adam.nu[k])
        for a, b in zip(_fields(io["stats"]), _fields(tr.stats)):
            a.copy_(b)
        for k in ("centers", "cls_ids", "leaf_centers", "leaf_cls_ids"):
            getattr(io["kms"], k).copy_(getattr(tr.kms, k))

    def copy_out(self, tr: "Trainer", count: int):
        """The trainer's state, moments and statistics as copies of the
        static buffers (a later replay overwrites the buffers)."""
        io = self.io
        tr.state = _clone_state(io["state"])
        tr.adam = opt_mod.AdamState(mu={k: v.clone() for k, v in io["mu"].items()},
                                    nu={k: v.clone() for k, v in io["nu"].items()},
                                    count=count)
        if self.stage == "0":
            tr.stats = G.DensifyStats(*(x.clone() for x in _fields(io["stats"])))

    def _body(self, write_back: bool):
        tr, io = self.tr, self.io
        o = tr.cfg.opt
        row = io["row"]
        keys = list(io["state"].params())
        vi, root = row[0:1].to(torch.int64), row[1:2].to(torch.int64)
        rescale, bg = row[2], row[3:6]
        hyper = StepHyper(lrs=dict(zip(keys, row[10:10 + len(keys)].unbind(0))),
                          bias=opt_mod.bias_tensors(row[6:10]),
                          sh_mask=row[10 + len(keys):])
        it = losses.LATE_ITERATION + 1 if self.late else 1  # the late flag alone
        state = io["state"]
        adam = opt_mod.AdamState(mu=io["mu"], nu=io["nu"], count=0)
        stats = None
        if self.stage == "0":
            state, adam, stats, loss, _psnr, lost = stage0_step(
                state, adam, io["stats"], tr.bundle, vi, it, bg, tr.spatial_lr_scale,
                tr.rcfg, o, hyper=hyper)
        elif self.stage == "1":
            fz = None if self.frozen is None else self.frozen.select(vi)
            state, adam, loss, lost = stage1_step(
                state, adam, tr.bundle, vi, it, bg, rescale, tr.rcfg, o, tr.any_alpha,
                frozen=fz, hyper=hyper)
        elif self.stage == "2.1":
            fz = None if self.frozen is None else self.frozen.select(vi)
            state, adam, loss, lost = stage21_step(
                state, adam, io["kms"], tr.bundle, vi, it, bg, rescale,
                _at(tr.pseudo.feat, vi), tr.rcfg, o, tr.any_alpha, frozen=fz, hyper=hyper)
        else:
            occur = tr.pseudo.cluster_occur
            vis = (torch.ones((), dtype=torch.bool, device=tr.device) if occur is None
                   else _at(_at(occur, vi), root))
            state, adam, loss, _ok, lost = stage22_step(
                state, adam, io["kms"], tr.bundle, vi, it, bg, rescale,
                _at(tr.pseudo.feat, vi), root, vis, tr.rcfg, o, tr.any_alpha,
                hyper=hyper)
        if not write_back:
            return
        for k, v in state.params().items():
            getattr(io["state"], k).copy_(v)
        for k in io["mu"]:
            io["mu"][k].copy_(adam.mu[k])
            io["nu"][k].copy_(adam.nu[k])
        if stats is not None:
            for a, b in zip(_fields(io["stats"]), _fields(stats)):
                a.copy_(b)
        io["loss"].copy_(loss)
        io["lost"].copy_(lost)

    def _capture(self):
        counters = {w: w.launches for w in rk.KERNEL_WRAPPERS}
        side = torch.cuda.Stream(self.tr.device)
        side.wait_stream(torch.cuda.current_stream(self.tr.device))
        with torch.cuda.stream(side):
            self._body(write_back=False)  # builds the kernels, sets their attributes
        torch.cuda.current_stream(self.tr.device).wait_stream(side)
        before = {w: w.launches for w in rk.KERNEL_WRAPPERS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body(write_back=True)
        self.deltas = {w: w.launches - before[w] for w in rk.KERNEL_WRAPPERS}
        for w, c in counters.items():
            w.launches = c
        self.graph = graph

    def run(self, row: torch.Tensor) -> torch.Tensor:
        """One step with the numbers of `row`. -> a copy of its loss."""
        self.io["row"].copy_(row)
        if self.tr.device.type != "cuda":
            self._body(write_back=True)
            return self.io["loss"].clone()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for w, d in self.deltas.items():
            w.launches += d
        return self.io["loss"].clone()
