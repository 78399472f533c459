"""Sharded training steps over a device mesh (port of
opengaussian_tpu/parallel/steps.py; stage 0 so far).

The rasterization runs through parallel/render.py:render_sharded (the
splats sharded for projection and the update, the tiles for the blend),
while the loss, an image-sized computation, runs on the whole image every
rank holds. Each rank then updates only its own shard of the parameters,
Adam's moments and the densification statistics. The step is the
single-device train/loop.py:stage0_step over the mesh: the SH warmup mask,
the L1 + SSIM loss, the alpha-mask loss gated per view, Adam, and the
statistics from the screen tap's gradient and this rank's radii.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.ops.sh import sh_to_rgb
from opengaussian_tpu_torch.parallel.mesh import Mesh
from opengaussian_tpu_torch.parallel.render import render_sharded
from opengaussian_tpu_torch.train import losses

_LEFT_OUT = ("the sharded steps of stages 1, 2.1 and 2.2 and the sharded evaluation "
             "render arrive with the mesh trainer (ROADMAP item 14b)")


def make_sharded_steps(mesh: Mesh, rcfg: RasterizeConfig, ocfg,
                       spatial_lr_scale: float = 1.0) -> SimpleNamespace:
    """-> a namespace of sharded steps: stage0; stage1, stage21, stage22 and
    eval_render raise NotImplementedError."""
    from opengaussian_tpu_torch.train.loop import _mask_sh

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
        rgb = sh_to_rgb(3, gs.sh, gs.means, camera.cam_center)
        cov = build_cov3d(gs.scales, gs.quats)
        img, alpha, _depth, radii, n_lost = render_sharded(
            mesh, camera, gs.means, cov, gs.opacity, rgb, bg, rcfg, screen_tap=tap)
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

    def left_out(*_args, **_kw):
        raise NotImplementedError(_LEFT_OUT)

    return SimpleNamespace(stage0=stage0, stage1=left_out, stage21=left_out,
                           stage22=left_out, eval_render=left_out)
