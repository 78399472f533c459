"""Training losses (port of opengaussian_tpu/train/losses.py): masked L1/L2
(reference utils/loss_utils.py:17-31), the photometric loss, PSNR, and the
stage-1 intra-mask cohesion (reference train.py:102-121) and inter-mask
separation (reference train.py:123-155) losses. Mask stacks are [M, H, W]
with a validity vector, as in the JAX package; the math over padded entries
reproduces the reference's dynamic shapes. `sam_mask_loss` is the stage-1
step's entry: on the card the cohesion loss and the mask means come from
per-mask sums by pixel id (ops/mask_loss_kernels.py), with no mask stack."""

from __future__ import annotations

import torch

from opengaussian_tpu_torch.ops.mask_loss_kernels import MaskLoss
from opengaussian_tpu_torch.ops.ssim import ssim
from opengaussian_tpu_torch.utils import masks as masku


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


def cohesion_loss(feat_map, masks, mask_valid, feat_means):
    """Intra-mask smoothing: pull each pixel's feature toward its mask mean.

    feat_map [H, W, C]; masks [M, H, W] bool; mask_valid [M] bool;
    feat_means [M, C]. Per mask: mean over its pixels of ||f(p) - mean||_2;
    averaged over valid masks."""
    m = masks.to(torch.float32)
    # double where: exact-zero differences (empty masks, background pixels)
    # must not give sqrt's infinite derivative, which 0 * inf makes NaN
    diff = feat_map[None] - feat_means[:, None, None, :]
    sq = (diff * diff).sum(dim=-1)
    pos = sq > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0) * m
    per_mask = dist.sum(dim=(1, 2)) / torch.clamp(m.sum(dim=(1, 2)), min=1.0)
    per_mask = torch.where(mask_valid, per_mask, 0.0)
    return per_mask.sum() / torch.clamp(mask_valid.sum(), min=1)


LATE_ITERATION = 35_000  # past it the separation loss focuses on hard pairs


def separation_loss(feat_means, mask_valid, iteration: int):
    """Inter-mask contrastive loss: inverse squared distances between mask
    mean features, with the reference's rank-based pair weighting and the
    >35k-iteration hard-pair focus. feat_means [M, C] (padded rows
    arbitrary); mask_valid [M] bool."""
    M = feat_means.shape[0]
    v = mask_valid
    n_valid = v.sum().to(torch.float32)  # the reference's N
    pair_valid = v[:, None] & v[None, :]
    diff2 = ((feat_means[:, None, :] - feat_means[None, :, :]) ** 2).sum(dim=-1)
    inv = 1.0 / (diff2 + 1.0)
    eye = torch.eye(M, dtype=torch.bool, device=feat_means.device)
    inv = torch.where(eye | ~pair_valid, 0.0, inv)
    # rank ascending per row; invalid entries sort below everything, so valid
    # entries keep the ranks they have in the dynamic version
    rank_key = torch.where(pair_valid & ~eye, inv, -1.0)
    ranks = torch.argsort(torch.argsort(rank_key, dim=1, stable=True), dim=1,
                          stable=True).to(torch.float32)
    ref_rank = ranks - (M - n_valid)  # diagonal ~0, valid pairs 1..n_valid-1
    weight = (ref_rank / torch.clamp(n_valid - 1.0, min=1.0)) * 0.9 + 0.1
    weight = torch.clamp(weight, 0.1, 1.0)
    if iteration > LATE_ITERATION:
        weight = torch.where(weight < 0.9, 0.1, weight)
    inv = inv * weight
    return inv.sum() / torch.clamp(n_valid * (n_valid - 1.0), min=1.0)


def sam_mask_loss(feat_map, ids, sil, max_masks: int, iteration: int, loss_weight: float):
    """The stage-1 losses of the feature image [H, W, C] against the view's
    SAM ids [H, W] (0 invalid, masks 1..max_masks), the mask means weighted
    by sil [H, W] (the silhouette > 0.7): -> (separation, loss_weight *
    cohesion). CPU tensors run `sam_mask_loss_plain`; CUDA tensors take the
    means and the cohesion loss from the per-mask sums by id, forward and
    backward in kernels (`mask_loss_kernels.MaskLoss`), and the separation
    loss from those means."""
    if feat_map.device.type == "cpu":
        return sam_mask_loss_plain(feat_map, ids, sil, max_masks, iteration, loss_weight)
    means, valid, coh = MaskLoss.apply(feat_map, ids, sil, max_masks)
    return separation_loss(means, valid, iteration), loss_weight * coh


def sam_mask_loss_plain(feat_map, ids, sil, max_masks: int, iteration: int,
                        loss_weight: float):
    """sam_mask_loss over dense mask stacks [M, H, W], as the JAX package
    computes it."""
    masks, valid = masku.masks_onehot(ids, max_masks)
    means = masku.mask_feature_mean(feat_map, masks, image_mask=sil)
    return (separation_loss(means, valid, iteration),
            loss_weight * cohesion_loss(feat_map, masks, valid, means))


def psnr(pred, gt):
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
