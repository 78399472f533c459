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
stacked tensors (`ViewBundle`). Checkpoints (`save_checkpoint`,
`restore_checkpoint`) use train/checkpoint.py.

The port runs eagerly: a step is one Python function, with no jit and no
scanned blocks of steps. Its binning sizes the slot buffer per frame, so of
the JAX trainer's budget probe only the per-tile cap is left: the trainer
raises max_per_tile past the deepest tile it finds, as the JAX trainer's
probe does, so that no slot is truncated; group renders use the same cap
(the JAX package's per-group budgets are not ported). What the port leaves
out so far raises NotImplementedError: save_memory and lazy view bundles,
the device mesh, the SAM mask refiner, frozen binning plans, training dumps
and TensorBoard.
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
from opengaussian_tpu_torch.data.ply import save_gaussian_ply
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models import gaussians as G
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops import kmeans as km
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, deepest_tile
from opengaussian_tpu_torch.render import render, render_clusters
from opengaussian_tpu_torch.train import checkpoint as ckpt
from opengaussian_tpu_torch.train import lang, losses
from opengaussian_tpu_torch.train import pseudo as pseudo_mod
from opengaussian_tpu_torch.utils import codebook as cb
from opengaussian_tpu_torch.utils import masks as masku

HEADROOM = 1.3  # scenes evolve between probes (the JAX package's ops/budget.py)


@dataclasses.dataclass(frozen=True)
class ViewBundle:
    """Every training view, stacked on one device."""

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

    def camera(self, i: int) -> Camera:
        return Camera(R_w2c=self.R[i], t_w2c=self.t[i], fx=self.fx[i], fy=self.fy[i],
                      cx=self.cx[i], cy=self.cy[i], width=self.width,
                      height=self.height)

    @property
    def num_views(self) -> int:
        return self.gt_images.shape[0]


def bundle_views(views: list[View], sam_level: int, device="cuda") -> ViewBundle:
    """Stack `views` on `device` (the JAX package's device-resident bundle)."""
    if not views:
        raise ValueError("no views")
    dev = resolve_device(device)
    h, w = views[0].gt_image.shape[:2]
    for v in views:
        if v.gt_image.shape[:2] != (h, w):
            raise ValueError("views must share a resolution")
    ids = []
    max_masks = 8
    for v in views:
        if v.sam_mask is not None:
            m = masku.decode_sam_level(np.asarray(v.sam_mask), sam_level)
            max_masks = max(max_masks, int(m.max()))
            ids.append(m.astype(np.int32))
        else:
            ids.append(np.zeros((h, w), np.int32))
    max_masks = int(np.ceil(max_masks / 8) * 8)

    def t(x, dtype=np.float32):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    return ViewBundle(
        R=t(np.stack([v.camera.R_w2c.cpu().numpy() for v in views])),
        t=t(np.stack([v.camera.t_w2c.cpu().numpy() for v in views])),
        fx=t([float(v.camera.fx) for v in views]),
        fy=t([float(v.camera.fy) for v in views]),
        cx=t([float(v.camera.cx) for v in views]),
        cy=t([float(v.camera.cy) for v in views]),
        gt_images=t(np.stack([np.asarray(v.gt_image, np.float32) for v in views])),
        alpha_masks=t(np.stack([
            np.asarray(v.gt_alpha_mask, np.float32) if v.gt_alpha_mask is not None
            else np.ones((h, w), np.float32) for v in views])),
        has_alpha=t([v.gt_alpha_mask is not None for v in views], bool),
        sam_ids=t(np.stack(ids), np.int32),
        width=w, height=h, max_masks=max_masks,
    )


def _mask_sh(gs: G.GaussianState, iteration: int) -> G.GaussianState:
    """SH-degree warmup: the degree rises every 1000 iterations (reference
    train.py:255-256); inactive coefficients are multiplied by 0, which also
    blocks their gradients, as rendering at a lower degree would."""
    n_active = (min(iteration // 1000, 3) + 1) ** 2
    idx = torch.arange(gs.sh_rest.shape[1], device=gs.device) + 1
    mask = (idx < n_active).to(gs.sh_rest.dtype)
    return dataclasses.replace(gs, sh_rest=gs.sh_rest * mask[None, :, None])


def stage0_step(state: G.GaussianState, adam: opt_mod.AdamState, stats: G.DensifyStats,
                bundle: ViewBundle, view_idx: int, iteration: int, bg: torch.Tensor,
                spatial_lr_scale: float, rcfg: RasterizeConfig,
                ocfg: OptimizationConfig):
    """One stage-0 step (the JAX package's _stage0_body): render the color
    pass with the screen tap, loss, gradients, Adam, densify statistics.
    -> (state, adam, stats, loss, psnr, n_lost), the last three 0-d tensors."""
    gt = bundle.gt_images[view_idx]
    params = {k: v.detach().requires_grad_(True) for k, v in state.params().items()}
    tap = torch.zeros((state.capacity, 2), device=state.device, requires_grad=True)
    gs = _mask_sh(state.with_params(params), iteration)
    out = render(bundle.camera(view_idx), gs, bg, 3, rcfg, screen_tap=tap)
    loss = losses.rgb_loss(out.render, gt, ocfg.lambda_dssim)
    loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    leaves = list(params.values()) + [tap]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # ins_feat is not rendered by the color pass: its gradient is zero
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    p_grads = dict(zip(params, grads[:-1]))
    lrs = opt_mod.learning_rates(ocfg, iteration, spatial_lr_scale)
    new_p, adam = opt_mod.apply(state.params(), p_grads, adam, lrs)
    stats = stats.update(grads[-1], out.radii)
    with torch.no_grad():
        psnr = losses.psnr(out.render, gt)
    return (state.with_params(new_p), adam, stats, loss.detach(), psnr,
            out.n_lost)


def _freeze_geometry(params: dict) -> dict:
    """Every leaf but ins_feat detached; ins_feat a fresh leaf that requires
    grad (the JAX package's stop_gradient on the geometry)."""
    return {k: v.detach().requires_grad_(k == "ins_feat") for k, v in params.items()}


def _alpha_mask_loss(out_alpha, bundle: ViewBundle, view_idx: int):
    """Per-view gate: maskless views carry an all-ones placeholder that must
    not be regressed against (reference train.py:491 checks per camera)."""
    return torch.where(bundle.has_alpha[view_idx],
                       ((out_alpha - bundle.alpha_masks[view_idx]) ** 2).mean(), 0.0)


def _feature_update(state: G.GaussianState, adam: opt_mod.AdamState, params: dict, loss,
                    iteration: int, ocfg: OptimizationConfig, keep=None):
    """Adam on every leaf with the gradient by ins_feat alone (the frozen
    leaves get zeros and learning rate 0, so they stay as they were). keep
    (a 0-d bool tensor): where False, the gradient is zero, but Adam still
    steps."""
    (g,) = torch.autograd.grad(loss, [params["ins_feat"]])
    if keep is not None:
        g = torch.where(keep, g, 0.0)
    grads = {k: g if k == "ins_feat" else torch.zeros_like(v) for k, v in params.items()}
    lrs = opt_mod.learning_rates(ocfg, iteration, 1.0)
    new_p, adam = opt_mod.apply(state.params(), grads, adam, lrs)
    return state.with_params(new_p), adam


def stage1_step(state: G.GaussianState, adam: opt_mod.AdamState, bundle: ViewBundle,
                view_idx: int, iteration: int, bg: torch.Tensor, rescale_factor: float,
                rcfg: RasterizeConfig, ocfg: OptimizationConfig,
                with_alpha_loss: bool = False):
    """One stage-1 step (the JAX package's _stage1_body): the feature pass of
    the frozen geometry, mask means inside the silhouette, separation +
    loss_weight * cohesion against the view's SAM masks.
    -> (state, adam, loss, n_lost), the last two 0-d tensors."""
    params = _freeze_geometry(state.params())
    out = render(bundle.camera(view_idx), state.with_params(params), bg, 3, rcfg,
                 render_color=with_alpha_loss, render_feat_map=True,
                 rescale_factor=rescale_factor)
    sil = (out.silhouette > 0.7).to(torch.float32)
    masks, valid = masku.masks_onehot(bundle.sam_ids[view_idx], bundle.max_masks)
    means = masku.mask_feature_mean(out.ins_feat, masks, image_mask=sil)
    l_coh = losses.cohesion_loss(out.ins_feat, masks, valid, means)
    l_sep = losses.separation_loss(means, valid, iteration)
    loss = l_sep + ocfg.loss_weight * l_coh
    if with_alpha_loss:
        loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg)
    return state, adam, loss.detach(), out.n_lost


def stage21_step(state: G.GaussianState, adam: opt_mod.AdamState, kms: km.KMeansState,
                 bundle: ViewBundle, view_idx: int, iteration: int, bg: torch.Tensor,
                 rescale_factor: float, pseudo_feat: torch.Tensor, rcfg: RasterizeConfig,
                 ocfg: OptimizationConfig, with_alpha_loss: bool = False):
    """One stage-2.1 step (the JAX package's _stage21_body; reference
    train.py:464-473): L1 of the rendered root-quantized features against
    the view's pseudo features, inside the rendered silhouette.
    -> (state, adam, loss, n_lost), the last two 0-d tensors."""
    params = _freeze_geometry(state.params())
    q = km.quantize(kms, params["ins_feat"], "root")
    out = render(bundle.camera(view_idx), state.with_params(params), bg, 3, rcfg,
                 render_color=with_alpha_loss, render_feat_map=True, quantized_feat=q,
                 rescale_factor=rescale_factor)
    keep = (out.silhouette > 0.7).to(torch.float32)[..., None]
    loss = losses.l1_loss(out.ins_feat, pseudo_feat, keep)
    if with_alpha_loss:
        loss = loss + _alpha_mask_loss(out.alpha, bundle, view_idx)
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg)
    return state, adam, loss.detach(), out.n_lost


def stage22_step(state: G.GaussianState, adam: opt_mod.AdamState, kms: km.KMeansState,
                 bundle: ViewBundle, view_idx: int, iteration: int, bg: torch.Tensor,
                 rescale_factor: float, pseudo_feat: torch.Tensor, root_id: int,
                 root_visible, rcfg: RasterizeConfig, ocfg: OptimizationConfig,
                 with_alpha_loss: bool = False):
    """One stage-2.2 step (the JAX package's _stage22_body; reference
    train.py:475-497): render the root cluster root_id alone with
    leaf-quantized features, L2 against the view's pseudo features inside
    the cluster's silhouette. Where the root does not occur in the render
    or root_visible (sweep 2's verdict for this view, a 0-d bool tensor or
    bool) is false, the loss and the gradient are zero, but Adam still
    steps. -> (state, adam, loss, ok, n_lost), the last three 0-d tensors."""
    params = _freeze_geometry(state.params())
    q = km.quantize(kms, params["ins_feat"], "leaf")
    gs = state.with_params(params)
    cam = bundle.camera(view_idx)
    out = render_clusters(cam, gs, bg, kms.cls_ids, [root_id], rcfg, quantized_feat=q,
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
    state, adam = _feature_update(state, adam, params, loss, iteration, ocfg, keep=ok)
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
    order, so both trainers visit the same views; the split noise of
    densification and the k-means++ seeds come from a torch.Generator
    seeded with `seed` on the training device."""

    def __init__(self, scene: Scene, cfg: Config, out_dir: str,
                 rcfg: RasterizeConfig | None = None, seed: int = 0,
                 device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "training over a device mesh arrives with the port's multi-GPU slice")
        if cfg.opt.save_memory:
            raise NotImplementedError(
                "save_memory (host-resident bundles) arrives with a later slice "
                "of the port; the port keeps every view on the device")
        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cfg_args.json"), "w") as f:
            f.write(cfg.to_json())

        # sorted order is load-bearing for pseudo labels (reference train.py:673)
        self.train_views = sorted(scene.train_views, key=lambda v: v.image_name)
        self.bundle = bundle_views(self.train_views, cfg.opt.sam_level, self.device)
        self.test_bundle = (
            bundle_views(sorted(scene.test_views, key=lambda v: v.image_name),
                         cfg.opt.sam_level, self.device)
            if scene.test_views else None)
        self.rcfg = rcfg or RasterizeConfig()
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
            device=self.device)
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
        self._view_queue: list[int] = []
        self._last_lost: torch.Tensor | None = None
        self.losses: list[torch.Tensor] = []  # every step's loss, on the device
        self.history: list[dict] = []

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
            return torch.as_tensor(self.rng.random(3), dtype=torch.float32,
                                   device=self.device)
        return self.bg

    def _fit_max_per_tile(self):
        """The JAX trainer's budget probe (ops/budget.py:probe, tuned_config)
        for the one budget the port keeps: over up to 4 evenly spaced views,
        find the deepest tile and raise max_per_tile to 1.3x of it (rounded
        up to the chunk) when the cap is lower. Like the JAX trainer, runs
        before the first step, after a capacity growth and after a logged
        step that lost slots."""
        V = self.bundle.num_views
        cov3d = build_cov3d(self.state.scales, self.state.quats)
        cnt = max(deepest_tile(self.bundle.camera(i), self.state.means, cov3d,
                               self.state.opacity, self.rcfg)
                  for i in list(range(0, V, max(1, V // 4)))[:4])
        chunk = self.rcfg.chunk
        k = -(-int(cnt * HEADROOM) // chunk) * chunk
        if k > self.rcfg.max_per_tile:
            print(f"[budget] max_per_tile {self.rcfg.max_per_tile}->{k} "
                  f"(deepest tile {cnt})", flush=True)
            self.rcfg = dataclasses.replace(self.rcfg, max_per_tile=k)
        self._budgets_tuned = True

    def _maybe_grow(self):
        """Double the capacity when more than 90% of the slots are alive."""
        if int(self.state.num_alive) / self.state.capacity > 0.9:
            new_cap = G.round_capacity(int(self.state.capacity * 2))
            self.state = G.grow_capacity(self.state, new_cap)
            self.adam = opt_mod.AdamState(mu=G.grow_capacity(self.adam.mu, new_cap),
                                          nu=G.grow_capacity(self.adam.nu, new_cap),
                                          count=self.adam.count)
            self.stats = G.grow_capacity(self.stats, new_cap)
            self.kms = self.kms.grow(new_cap)
            self._budgets_tuned = False  # re-probe at the new scale

    def _rescale_factor(self, it: int) -> float:
        """50% chance of a uniform rescale once past start_root_cb_iter
        (reference gaussian_renderer/__init__.py:121-124, train.py:347-350)."""
        if it <= self.cfg.opt.start_root_cb_iter:
            return 1.0
        if self.rng.random() > 0.5:
            return float(self.rng.random())
        return 1.0

    def _ensure_pseudo(self, mode: str):
        o = self.cfg.opt
        cams = [self.bundle.camera(i) for i in range(self.bundle.num_views)]
        self.pseudo = pseudo_mod.construct_pseudo_labels(
            self.state, cams, self.bundle.sam_ids, self.bg, self.bundle.max_masks,
            self.rcfg, mode=mode, cls_ids=self.kms.cls_ids, k1=o.root_node_num,
            k2=o.leaf_node_num)
        if mode == "leaf":
            self.kms = dataclasses.replace(self.kms, leaf_sub_num=self.pseudo.leaf_sub_num)

    def _pre_events(self, it: int, stage: str):
        """Events BEFORE step `it` (reference train.py:265-355, 393-426):
        sweep 1 at stage-2.1 entry, and the root k-means there and every 200
        iterations; sweeps 1 and 2 at stage-2.2 entry, and the leaf k-means
        of the current root there and every 50 iterations."""
        o = self.cfg.opt
        if it == o.start_root_cb_iter + 1:
            self._ensure_pseudo("root")
        if it == o.start_leaf_cb_iter + 1:
            self._ensure_pseudo("leaf")
        if stage == "2.1" and (it % 200 == 1 or it == o.start_root_cb_iter + 1):
            self.kms = km.assign_root(
                self.kms, self.state.ins_feat, self.state.means, self.state.alive,
                o.pos_weight, self.generator, init=(it == o.start_root_cb_iter + 1))
        elif stage == "2.2" and (it % 50 == 1 or it == o.start_leaf_cb_iter + 1):
            self.kms = km.assign_leaf(
                self.kms, self.state.ins_feat, self.state.alive, self.root_id,
                o.leaf_node_num, self.generator, init=(it == o.start_leaf_cb_iter + 1))

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
                self._fit_max_per_tile()
            it = self.iteration + 1
            stage = self._stage(it)
            if stage == "2.2" and (it - o.start_leaf_cb_iter) % o.leaf_update_fr == 0:
                self.root_id = (self.root_id + 1) % o.root_node_num
            self._pre_events(it, stage)
            loss = self._run_single(it, stage)
            self.losses.append(loss)
            self.iteration = it
            self._post_events(it, stage)
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
                print(f"[it {it}] stage {stage} loss {rec['loss']:.5f} "
                      f"pts {rec['num_alive']} ({rec['elapsed']:.0f}s)", flush=True)

    def _run_single(self, it: int, stage: str) -> torch.Tensor:
        o = self.cfg.opt
        vi = self._next_view()
        bg = self._bg_for(stage)
        if stage == "0":
            self.state, self.adam, self.stats, loss, _psnr, self._last_lost = stage0_step(
                self.state, self.adam, self.stats, self.bundle, vi, it, bg,
                self.spatial_lr_scale, self.rcfg, o)
        elif stage == "1":
            self.state, self.adam, loss, self._last_lost = stage1_step(
                self.state, self.adam, self.bundle, vi, it, bg, self._rescale_factor(it),
                self.rcfg, o, self.any_alpha)
        elif stage == "2.1":
            self.state, self.adam, loss, self._last_lost = stage21_step(
                self.state, self.adam, self.kms, self.bundle, vi, it, bg,
                self._rescale_factor(it), self.pseudo.feat[vi], self.rcfg, o,
                self.any_alpha)
        else:
            occur = self.pseudo.cluster_occur if self.pseudo is not None else None
            root_vis = occur[vi, self.root_id] if occur is not None else True
            self.state, self.adam, loss, _ok, self._last_lost = stage22_step(
                self.state, self.adam, self.kms, self.bundle, vi, it, bg,
                self._rescale_factor(it), self.pseudo.feat[vi], self.root_id, root_vis,
                self.rcfg, o, self.any_alpha)
        return loss

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
        psnrs, l1s = [], []
        for i in range(n):
            _img, p, l1 = eval_view(self.state, bundle, i, self.bg, self.rcfg)
            psnrs.append(float(p))
            l1s.append(float(l1))
        return dict(psnr=float(np.mean(psnrs)), l1=float(np.mean(l1s)), views=n)

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
        self.state = ckpt.ensure_ins_feat(self.state)
        if self.state.capacity != self.kms.cls_ids.shape[0]:
            o = self.cfg.opt
            self.kms = km.KMeansState.create(self.state.capacity, o.root_node_num,
                                             o.leaf_node_num, self.device)
        self._budgets_tuned = False
