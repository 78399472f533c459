"""Training losses (port of opengaussian_tpu/train/losses.py, the stage-0
part): masked L1/L2 (reference utils/loss_utils.py:17-31), the photometric
loss and PSNR. The stage-1 cohesion and separation losses come with the
feature-stage slice of the port."""

from __future__ import annotations

import torch

from opengaussian_tpu_torch.ops.ssim import ssim


def l1_loss(pred, gt, mask=None, weight=None):
    if mask is None:
        return (pred - gt).abs().mean()
    if weight is None:
        weight = 1.0
    return ((pred - gt) * mask * weight).abs().sum() / torch.clamp(mask.sum(), min=1.0)


def l2_loss(pred, gt, mask=None, weight=None):
    if mask is None:
        return ((pred - gt) ** 2).mean()
    if weight is None:
        weight = 1.0
    return ((pred - gt) ** 2 * mask * weight).sum() / torch.clamp(mask.sum(), min=1.0)


def rgb_loss(pred, gt, lambda_dssim: float = 0.2):
    """Stage-0 photometric loss: (1-l)*L1 + l*(1-SSIM) (reference train.py:384-386)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (
        1.0 - ssim(pred, gt))


def psnr(pred, gt):
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
