"""Training loop, stage 0 (3DGS pretraining).

Port of the stage-0 half of opengaussian_tpu/train/loop.py (reference
train.py:157-635). Every view's ground truth and camera sits on the device
in stacked tensors (`ViewBundle`); one step renders the color pass with the
screen tap, takes the L1 + SSIM loss, differentiates it (the blend's
backward is the K2 + K3 kernels, ops/rasterize.py:StreamBlend), applies
Adam and accumulates the densification statistics. Densification and the
opacity reset run between steps, as in the JAX package.

The port runs eagerly: a step is one Python function, with no jit and no
scanned blocks of steps. Its binning sizes the slot buffer per frame, so of
the JAX trainer's budget probe only the per-tile cap is left: the trainer
raises max_per_tile past the deepest tile it finds, as the JAX trainer's
probe does, so that no slot is truncated. What this slice leaves out raises
NotImplementedError: the stages past stage 0 (iterations past
start_ins_feat_iter), save_memory and lazy view bundles, the device mesh,
frozen binning plans, training dumps and TensorBoard.
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
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, deepest_tile
from opengaussian_tpu_torch.render import render
from opengaussian_tpu_torch.train import losses
from opengaussian_tpu_torch.utils.masks import decode_sam_level

LATER_STAGES = "the feature stages (1-3) arrive with later slices of the port"
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
            m = decode_sam_level(np.asarray(v.sam_mask), sam_level)
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
    loss = loss + torch.where(
        bundle.has_alpha[view_idx],
        ((out.alpha - bundle.alpha_masks[view_idx]) ** 2).mean(), 0.0)
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


@torch.no_grad()
def eval_view(state: G.GaussianState, bundle: ViewBundle, view_idx: int, bg,
              rcfg: RasterizeConfig):
    """-> (image clipped to [0, 1], psnr, l1) of one view."""
    out = render(bundle.camera(view_idx), state, bg, 3, rcfg)
    img = torch.clamp(out.render, 0.0, 1.0)
    gt = bundle.gt_images[view_idx]
    return img, losses.psnr(img, gt), losses.l1_loss(img, gt)


class Trainer:
    """Host-side stage-0 trainer (the JAX package's Trainer, stage 0).

    View order and the random background come from
    np.random.default_rng(seed), as in the JAX package, so both trainers
    visit the same views; the split noise of densification comes from a
    torch.Generator seeded with `seed` on the training device."""

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
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.iteration = 0
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
        raise NotImplementedError(
            f"iteration {it} is past start_ins_feat_iter={o.start_ins_feat_iter}: "
            + LATER_STAGES)

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
            self._budgets_tuned = False  # re-probe at the new scale

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
        until = until or self.cfg.opt.iterations
        self._stage(until)  # raises before any step if stage 0 does not cover it
        t_start = time.time()
        while self.iteration < until:
            if not self._budgets_tuned:
                self._fit_max_per_tile()
            it = self.iteration + 1
            stage = self._stage(it)
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
                self.history.append(rec)
                print(f"[it {it}] stage {stage} loss {rec['loss']:.5f} "
                      f"pts {rec['num_alive']} ({rec['elapsed']:.0f}s)", flush=True)

    def _run_single(self, it: int, stage: str) -> torch.Tensor:
        vi = self._next_view()
        bg = self._bg_for(stage)
        self.state, self.adam, self.stats, loss, _psnr, self._last_lost = stage0_step(
            self.state, self.adam, self.stats, self.bundle, vi, it, bg,
            self.spatial_lr_scale, self.rcfg, self.cfg.opt)
        return loss

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
        pc_dir = os.path.join(self.out_dir, f"point_cloud/iteration_{self.iteration}")
        os.makedirs(pc_dir, exist_ok=True)
        save_gaussian_ply(os.path.join(pc_dir, "point_cloud.ply"), self.state)
