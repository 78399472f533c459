"""Per-parameter-group Adam with the reference's learning-rate schedules.

Port of opengaussian_tpu/models/optimizer.py. The reference builds one torch
Adam with seven param groups and mutates group LRs every step (reference
scene/gaussian_model.py:211-247). Here, as in the JAX package, the optimizer
is a function over the GaussianState params dict and plain tensors of
moments, so that densification's moment surgery (models/gaussians.py) acts on
those tensors directly; the per-leaf learning rates come from the iteration
number.

Torch-Adam semantics: beta=(0.9, 0.999), eps=1e-15 added OUTSIDE the sqrt,
bias correction by one step count shared by all leaves.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from opengaussian_tpu_torch.config import OptimizationConfig

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: int  # steps taken


def init(params: dict) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


def apply(params: dict, grads: dict, state: AdamState, lrs: dict) -> tuple[dict, AdamState]:
    """One Adam step. -> (new params, new state); the inputs are not changed."""
    count = state.count + 1
    # the bias corrections in float32, as the JAX package computes them
    t = torch.tensor(float(count), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(BETA1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(BETA2, dtype=torch.float32) ** t)
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * state.mu[k] + (1.0 - BETA1) * g
        v = BETA2 * state.nu[k] + (1.0 - BETA2) * g * g
        new_p[k] = p - lrs[k] * (m / c1) / (torch.sqrt(v / c2) + EPS)
        mu[k], nu[k] = m, v
    return new_p, AdamState(mu=mu, nu=nu, count=count)


def expon_lr(step: int, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolation with optional delayed warmup (the Plenoxels
    schedule the reference uses, utils/general_utils.py:29-62)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(opt: OptimizationConfig, iteration: int,
                   spatial_lr_scale: float) -> dict:
    """Per-leaf LRs matching GaussianState.params() (reference
    scene/gaussian_model.py:216-224 and 236-247): xyz on the exponential
    schedule scaled by the scene extent; ins_feat at 1e-4 during stage 2.1
    and 1e-3 otherwise; geometry and appearance at 0 past stage 0 (the
    reference detaches them, train.py:429-436); frozen_init_pts zeroes the
    position LR."""
    xyz_lr = expon_lr(iteration, opt.position_lr_init * spatial_lr_scale,
                      opt.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt.position_lr_delay_mult,
                      max_steps=opt.position_lr_max_steps)
    if opt.frozen_init_pts:
        xyz_lr = 0.0
    in_stage21 = opt.start_root_cb_iter < iteration <= opt.start_leaf_cb_iter
    geo = 0.0 if iteration > opt.start_ins_feat_iter else 1.0
    return dict(
        means=xyz_lr * geo,
        sh_dc=opt.feature_lr * geo,
        sh_rest=opt.feature_lr / 20.0 * geo,
        logit_opacity=opt.opacity_lr * geo,
        log_scales=opt.scaling_lr * geo,
        quats=opt.rotation_lr * geo,
        ins_feat=1e-4 if in_stage21 else 1e-3,
    )
