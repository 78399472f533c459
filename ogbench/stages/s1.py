"""Stage 1, instance features: ins_feat alone takes gradients, through the
encoded features (normalised, shifted to [0, 1]); the geometry is frozen.
The loss is separation + loss_weight x cohesion over the view's SAM masks
inside the silhouette above 0.7 (ogbench/reference.py has the plain
maths). The draws and the blend work are stage 0's."""

from __future__ import annotations

import torch

from ogbench import counts
from ogbench import reference as R
from ogbench.stages import follow_steps
from ogbench.stages.s0 import draws, view_work  # noqa: F401 (the stage's interface)

payload_width = 7  # 6 feature channels and depth


def step_grads(ar: R.Arith, params: dict, view: dict, it: int, *, alive, bg, opt: dict,
               max_masks: int, fault: str | None):
    """The loss and the gradient by every leaf of one step on `view`."""
    leaves = R.leaves_of(params)
    with torch.no_grad():
        opacity = torch.where(alive, torch.sigmoid(leaves["logit_opacity"]), 0.0)
        cov = R.covariance(leaves["log_scales"], leaves["quats"])
    payload = R.feature_colour(leaves["ins_feat"])
    proj = R.project(ar, view, leaves["means"].detach(), cov, opacity)
    n = R.loss_rows(view, fault)

    def loss_of(img, alpha):
        sil = (alpha > 0.7).to(torch.float32)
        ids = view["ids"].clone()
        ids[n:] = 0
        return R.mask_losses(ar, img, sil, ids, max_masks, it, opt["loss_weight"])

    loss = R.blend_grads(ar, view, proj, payload, torch.cat([bg, bg]), loss_of)
    return loss, R.grads_of(leaves)


def follow(cfg: dict, traffic: dict, inputs: dict, seed: int, device, precision: str = "fp32",
           fault: str | None = None) -> dict:
    seq = draws(seed, len(inputs["cams"]), int(traffic["check_steps"]))
    return follow_steps(step_grads, seq, cfg, traffic, inputs, device, precision, fault)


def step_ops(work: dict, n_splats: int, capacity: int, width: int, height: int) -> int:
    """The blend, the geometry forward and the feature encoding forward and
    backward (3x) of every splat, the mask losses forward and backward over
    the frame (per pixel: the mask means 2 x 6, the cohesion 3 x 6 + 4),
    Adam over the table."""
    ops = counts.blend_ops(work, payload_width)
    ops += n_splats * counts.OPS_GEOMETRY + 3 * n_splats * counts.OPS_FEATURE
    ops += 3 * width * height * (2 * 6 + 3 * 6 + 4)
    return ops + counts.adam_ops(capacity)
