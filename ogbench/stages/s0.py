"""Stage 0, 3DGS pretraining: every geometry and appearance leaf takes
gradients through the SH colour and the projection; the loss is
0.8 L1 + 0.2 (1 - SSIM) against the view's image (ogbench/reference.py
has the plain maths)."""

from __future__ import annotations

import torch

from ogbench import counts
from ogbench import reference as R
from ogbench.stages import TrainerRng, follow_steps

payload_width = 4  # RGB and depth


def draws(seed: int, n_views: int, n: int) -> list[dict]:
    """The views of the trainer's first n steps: no other draw falls in
    stages 0 and 1 of the benchmark's mixes (no random background)."""
    rng = TrainerRng(seed, n_views)
    return [dict(view=rng.view()) for _ in range(n)]


def step_grads(ar: R.Arith, params: dict, view: dict, it: int, *, alive, bg, opt: dict,
               max_masks: int, fault: str | None):
    """The loss and the gradient by every leaf of one step on `view`."""
    leaves = R.leaves_of(params)
    opacity = torch.where(alive, torch.sigmoid(leaves["logit_opacity"]), 0.0)
    centre = -(view["R"].T @ view["t"])
    cov = R.covariance(leaves["log_scales"], leaves["quats"])
    payload = R.sh_colour(ar, torch.cat([leaves["sh_dc"], leaves["sh_rest"]], 1),
                          leaves["means"], centre)
    proj = R.project(ar, view, leaves["means"], cov, opacity)
    n = R.loss_rows(view, fault)
    loss = R.blend_grads(ar, view, proj, payload, bg, lambda img, alpha: R.rgb_loss(
        ar, img[:n], view["gt"][:n], opt["lambda_dssim"]))
    return loss, R.grads_of(leaves)


def follow(cfg: dict, traffic: dict, inputs: dict, seed: int, device, precision: str = "fp32",
           fault: str | None = None) -> dict:
    seq = draws(seed, len(inputs["cams"]), int(traffic["check_steps"]))
    return follow_steps(step_grads, seq, cfg, traffic, inputs, device, precision, fault)


def view_work(ar: R.Arith, splats: dict, view: dict, draw: dict) -> dict:
    """The full frame's blend work on the start's splats."""
    cov = R.covariance(splats["log_scales"], splats["quats"])
    opacity = torch.where(splats["alive"], torch.sigmoid(splats["logit_opacity"]), 0.0)
    return counts.frame_work(R.project(ar, view, splats["means"], cov, opacity))


def step_ops(work: dict, n_splats: int, capacity: int, width: int, height: int) -> int:
    """The blend, the geometry and SH colour of every splat forward and
    backward (3x), L1 and SSIM over the frame's 3 channels forward and
    backward, Adam over the table."""
    ops = counts.blend_ops(work, payload_width)
    ops += 3 * n_splats * (counts.OPS_GEOMETRY + counts.OPS_SH)
    ops += 3 * width * height * 3 * (counts.OPS_L1 + counts.OPS_SSIM)
    return ops + counts.adam_ops(capacity)
