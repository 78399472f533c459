"""Sharded training steps of every stage over a device mesh (port of
opengaussian_tpu/parallel/steps.py).

The rasterization runs through parallel/render.py:render_sharded (the
splats sharded for projection and the update, the tiles for the blend),
while the loss, an image-sized computation (SSIM, the SAM mask sums, the
pseudo-label L1 / L2), runs on the whole image every rank holds. Each rank
then updates only its own shard of the parameters and Adam's moments.

Each step is its single-device counterpart in train/loop.py over the mesh:
  * stage 0: the SH warmup mask, the L1 + SSIM loss, the alpha-mask loss
    gated per view, Adam, and the densification statistics from the screen
    tap's gradient and this rank's radii;
  * stages 1, 2.1 and 2.2 freeze the geometry (`_freeze_geometry`): only
    ins_feat has a gradient. The feature pass renders at the rescaled
    scales; stage 1 takes the cohesion and separation losses inside the
    silhouette > 0.7, stage 2.1 the L1 of the root-quantized features
    (straight-through) against the pseudo features, stage 2.2 the L2 of the
    chosen root's leaf-quantized render, its opacity masked to the root's
    alive splats. The alpha term is a second sharded pass (the color pass)
    gated by has_alpha, and its n_lost joins the step's by maximum;
  * stage 2.2's `ok` (the root occurs in the render and in sweep 2's verdict
    for the view) zeroes the loss and every gradient when false. Its member
    count is summed over the mesh, so that every rank takes the same `ok`.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.distributed as dist

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops import kmeans as km
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.ops.sh import sh_to_rgb
from opengaussian_tpu_torch.parallel.mesh import Mesh
from opengaussian_tpu_torch.parallel.render import render_sharded
from opengaussian_tpu_torch.render import encoded_ins_feat
from opengaussian_tpu_torch.train import losses
from opengaussian_tpu_torch.utils import masks as masku


def make_sharded_steps(mesh: Mesh, rcfg: RasterizeConfig, ocfg,
                       spatial_lr_scale: float = 1.0) -> SimpleNamespace:
    """-> a namespace of sharded steps: stage0, stage1, stage21, stage22 and
    eval_render. Every rank calls each with its own shards of the state,
    Adam's moments, the statistics and the k-means assignments, and the same
    view, draws and iteration."""
    from opengaussian_tpu_torch.train.loop import _feature_update, _freeze_geometry, _mask_sh

    def _rgb_pass(gs, camera, bg, tap=None):
        rgb = sh_to_rgb(3, gs.sh, gs.means, camera.cam_center)
        cov = build_cov3d(gs.scales, gs.quats)
        return render_sharded(mesh, camera, gs.means, cov, gs.opacity, rgb, bg, rcfg,
                              screen_tap=tap)

    def _feat_pass(gs, camera, bg, rescale, quantized=None, opacity=None):
        feat = encoded_ins_feat(gs, quantized)
        cov = build_cov3d(gs.scales * rescale, gs.quats)
        return render_sharded(mesh, camera, gs.means, cov,
                              gs.opacity if opacity is None else opacity, feat,
                              torch.cat([bg, bg]), rcfg)

    def _alpha_term(gs, camera, bg, alpha_mask, has_alpha):
        """-> (the alpha-mask loss term, n_lost of its color pass): the pass
        renders under the same budgets and feeds the budget health."""
        if alpha_mask is None:
            return 0.0, torch.zeros((), dtype=torch.int32, device=gs.device)
        _img, alpha, _d, _r, lost = _rgb_pass(gs, camera, bg)
        term = torch.where(torch.as_tensor(has_alpha, device=gs.device),
                           ((alpha - alpha_mask) ** 2).mean(), 0.0)
        return term, lost

    def stage0(state, adam, stats, camera: Camera, gt, alpha_mask, iteration: int, bg,
               has_alpha=False):
        """One stage-0 step on this rank's shards: state, adam (its mu and
        nu) and stats hold this rank's rows. alpha_mask [H, W]: the view's
        alpha, or None; has_alpha (a bool or a 0-d bool tensor) gates its
        loss per view, since a maskless view carries an all-ones
        placeholder. -> (state, adam, stats, loss, aux) with aux image, psnr
        and n_lost."""
        camera = camera.to(state.device)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params().items()}
        tap = torch.zeros((state.capacity, 2), device=state.device, requires_grad=True)
        gs = _mask_sh(state.with_params(params), iteration)
        img, alpha, _depth, radii, n_lost = _rgb_pass(gs, camera, bg, tap)
        loss = losses.rgb_loss(img, gt, ocfg.lambda_dssim)
        if alpha_mask is not None:
            loss = loss + torch.where(torch.as_tensor(has_alpha, device=img.device),
                                      ((alpha - alpha_mask) ** 2).mean(), 0.0)
        leaves = list(params.values()) + [tap]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        lrs = opt_mod.learning_rates(ocfg, iteration, spatial_lr_scale)
        new_p, adam = opt_mod.apply(state.params(), dict(zip(params, grads[:-1])), adam, lrs)
        stats = stats.update(grads[-1], radii)
        with torch.no_grad():
            aux = dict(image=img.detach(), psnr=losses.psnr(img, gt), n_lost=n_lost)
        return state.with_params(new_p), adam, stats, loss.detach(), aux

    def stage1(state, adam, camera: Camera, sam, alpha_mask, iteration: int, bg, rescale,
               max_masks: int, has_alpha=False):
        """One stage-1 step: the feature pass of the frozen geometry at the
        rescaled scales, the SAM mask means inside the silhouette > 0.7,
        separation + loss_weight * cohesion. sam [H, W]: the view's mask
        ids. -> (state, adam, loss, n_lost)."""
        camera = camera.to(state.device)
        params = _freeze_geometry(state.params())
        gs = state.with_params(params)
        feat_img, sil_a, _d, _r, n_lost = _feat_pass(gs, camera, bg, rescale)
        sil = (sil_a > 0.7).to(torch.float32)
        masks, valid = masku.masks_onehot(sam, max_masks)
        means = masku.mask_feature_mean(feat_img, masks, image_mask=sil)
        loss = (losses.separation_loss(means, valid, iteration)
                + ocfg.loss_weight * losses.cohesion_loss(feat_img, masks, valid, means))
        a_term, a_lost = _alpha_term(gs, camera, bg, alpha_mask, has_alpha)
        loss = loss + a_term
        state, adam = _feature_update(state, adam, params, loss, iteration, ocfg)
        return state, adam, loss.detach(), torch.maximum(n_lost, a_lost)

    def stage21(state, adam, kms, camera: Camera, pseudo_feat, alpha_mask, iteration: int,
                bg, rescale, has_alpha=False):
        """One stage-2.1 step: the L1 of the root-quantized feature render
        against the view's pseudo features inside the silhouette > 0.7. kms:
        the centers whole, cls_ids this rank's rows. -> (state, adam, loss,
        n_lost)."""
        camera = camera.to(state.device)
        params = _freeze_geometry(state.params())
        q = km.quantize(kms, params["ins_feat"], "root")
        gs = state.with_params(params)
        feat_img, sil_a, _d, _r, n_lost = _feat_pass(gs, camera, bg, rescale, q)
        keep = (sil_a > 0.7).to(torch.float32)[..., None]
        a_term, a_lost = _alpha_term(gs, camera, bg, alpha_mask, has_alpha)
        loss = losses.l1_loss(feat_img, pseudo_feat, keep) + a_term
        state, adam = _feature_update(state, adam, params, loss, iteration, ocfg)
        return state, adam, loss.detach(), torch.maximum(n_lost, a_lost)

    def stage22(state, adam, kms, camera: Camera, pseudo_feat, root_id, root_visible,
                alpha_mask, iteration: int, bg, rescale, has_alpha=False):
        """One stage-2.2 step: the root cluster root_id alone (the opacity of
        every other splat masked to 0, which leaves the transmittance as the
        reference's re-launch over the root's splats does) with
        leaf-quantized features, the L2 against the pseudo features inside
        its silhouette > 0.7. ok: the root has a member on some rank, its
        render's alpha peaks above 0.8, and root_visible (sweep 2's verdict,
        a bool or 0-d bool tensor); where false the loss and the gradient
        are zero, but Adam still steps. -> (state, adam, loss, ok, n_lost)."""
        camera = camera.to(state.device)
        member = (kms.cls_ids == root_id) & state.alive
        n_member = member.sum().to(torch.int64)
        dist.all_reduce(n_member, group=mesh.group)
        params = _freeze_geometry(state.params())
        q = km.quantize(kms, params["ins_feat"], "leaf")
        gs = state.with_params(params)
        opac = torch.where(member, gs.opacity, 0.0)
        img, alpha, _d, _r, n_lost = _feat_pass(gs, camera, bg, rescale, q, opac)
        sil = (alpha > 0.7).to(torch.float32)[..., None]
        ok = ((alpha.max() > 0.8) & (n_member >= 1)
              & torch.as_tensor(root_visible, device=state.device))
        a_term, a_lost = _alpha_term(gs, camera, bg, alpha_mask, has_alpha)
        loss = torch.where(ok, losses.l2_loss(img, pseudo_feat, sil) + a_term, 0.0)
        state, adam = _feature_update(state, adam, params, loss, iteration, ocfg, keep=ok)
        return state, adam, loss.detach(), ok, torch.maximum(n_lost, a_lost)

    @torch.no_grad()
    def eval_render(state, camera: Camera, bg):
        """The color pass of the whole scene. -> (image, alpha, depth), the
        same on every rank."""
        img, alpha, depth, _r, _lost = _rgb_pass(state, camera.to(state.device), bg)
        return img, alpha, depth

    return SimpleNamespace(stage0=stage0, stage1=stage1, stage21=stage21, stage22=stage22,
                           eval_render=eval_render)
