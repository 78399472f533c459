"""The stage-1 SAM-mask losses' hand-written CUDA kernels
(csrc/mask_losses.cu) and their plain versions.

Each pixel carries one SAM id, so it lies in at most one mask, and every
per-mask quantity of the stage-1 losses is a sum over the pixels of one id:

  * `mask_loss_fwd`: per mask k (ids 1..M; 0 and ids past M are no mask)
    its pixel count, its silhouette weight and weighted feature sum, its
    mean (the sum over max(weight, 1)) and validity (count > 0); then each
    pixel's distance to its mask's mean, 0 where the square is exactly 0
    (the double where of `losses.cohesion_loss`), the mask's sum of those
    distances and of the unit differences (f - mean) / distance; and the
    cohesion loss, the valid masks' mean distances over max(n_valid, 1).
  * `mask_loss_bwd`: the feature image's gradient from those of the
    cohesion loss and of the means (the separation loss's, through them):
    a (f - mean) / distance where the distance is not 0, plus
    sil (d_mean - a T) / max(weight, 1), with a = d_coh / max(n_valid, 1) /
    max(count, 1) and T the mask's sum of unit differences.

They replace no Pallas kernel: the JAX package builds these losses from
dense [M, H, W] mask stacks (`losses.sam_mask_loss_plain` is that
arithmetic) and leaves them to XLA. `MaskLoss` is the autograd Function
through which `losses.sam_mask_loss` runs CUDA tensors; it saves the
forward's inputs and the per-mask tables, no per-pixel intermediate.

Each wrapper dispatches on the device of its inputs, as the rasterizer's
do (ops/rasterize_kernels.py): a CPU tensor runs the plain version
(`*_plain`, the same sums by id in PyTorch ops), a CUDA tensor launches
the kernels or raises, never falling back. Each wrapper counts its calls
that launched in `<wrapper>.launches` (the forward's call is four kernels
and a memset, the backward's one kernel). Neither syncs with the host, so
a captured step replays them. The feature image is float32 [H, W, C] with
C <= MAX_C, read in place at its row and pixel strides; the ids are int32
(others are converted), the silhouette weights float32 [H, W].
"""

from __future__ import annotations

import torch

MAX_C = 16  # kMaxC in csrc/mask_losses.cu
PIXELS_PER_BLOCK = 2048  # kPixelsPerBlock in csrc/mask_losses.cu: one row of partials each


def _launch(name: str, device: torch.device, *args) -> None:
    # imported here: rasterize_kernels lists this module's wrappers
    from opengaussian_tpu_torch.ops.rasterize_kernels import _launch as launch

    launch(name, device, *args)


def _device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def split_tables(tables: torch.Tensor, max_masks: int, C: int):
    """The forward's flat per-mask tables [M * (2C + 3) + 1] -> (stats
    [M, C+2]: count, silhouette weight, weighted feature sum; dist [M, C+1]:
    the sum of distances, the sum of unit differences; n_valid [1])."""
    a, b = max_masks * (C + 2), max_masks * (2 * C + 3)
    return (tables[:a].view(max_masks, C + 2), tables[a:b].view(max_masks, C + 1),
            tables[b:b + 1])


def _inputs(name: str, feat, ids, sil, max_masks: int):
    """The kernels' inputs: feat with contiguous channels (its rows and
    pixels at any stride), int32 ids and float32 sil, contiguous."""
    if feat.dim() != 3 or not 1 <= feat.shape[2] <= MAX_C:
        raise ValueError(f"{name}: feat must be [H, W, C] with 1 <= C <= {MAX_C}, "
                         f"got {tuple(feat.shape)}")
    if feat.dtype != torch.float32 or sil.dtype != torch.float32:
        raise ValueError(f"{name}: feat and sil must be float32, got {feat.dtype}, {sil.dtype}")
    if ids.shape != feat.shape[:2] or sil.shape != feat.shape[:2]:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} and sil {tuple(sil.shape)} must be "
                         f"feat's [H, W] {tuple(feat.shape[:2])}")
    if max_masks < 1:
        raise ValueError(f"{name}: max_masks must be at least 1, got {max_masks}")
    for nm, x in (("ids", ids), ("sil", sil)):
        if x.device != feat.device:
            raise ValueError(f"{name}: {nm} is on {x.device}, feat on {feat.device}")
    if feat.stride(2) != 1:
        feat = feat.contiguous()
    return feat, ids.to(torch.int32).contiguous(), sil.contiguous()


def _by_id(ids: torch.Tensor, max_masks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ids [H, W] -> (row [HW] int64: id - 1, or max_masks for no mask;
    in_mask [HW] bool)."""
    idv = ids.reshape(-1).to(torch.int64)
    in_mask = (idv >= 1) & (idv <= max_masks)
    return torch.where(in_mask, idv - 1, max_masks), in_mask


def _sum_by(row, x, max_masks: int):
    """Per-mask sums of x [HW, ...] by row (row max_masks dropped)."""
    out = torch.zeros((max_masks + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add(0, row, x)[:max_masks]


def _distances(f, means, row, in_mask):
    """Each pixel's difference from its mask's mean [HW, C] and distance
    [HW] (0 where the square is exactly 0, and at pixels of no mask)."""
    own = torch.cat([means, torch.zeros_like(means[:1])])[row]
    diff = f - own
    sq = (diff * diff).sum(dim=-1)
    pos = (sq > 0) & in_mask
    return diff, torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def mask_loss_fwd_plain(feat, ids, sil, max_masks: int):
    """mask_loss_fwd in plain PyTorch ops: the same sums by id."""
    M, C = max_masks, feat.shape[-1]
    f = feat.reshape(-1, C)
    w = sil.reshape(-1)
    row, in_mask = _by_id(ids, M)
    count = _sum_by(row, torch.ones_like(w), M)
    weight = _sum_by(row, w, M)
    sums = _sum_by(row, w[:, None] * f, M)
    means = sums / torch.clamp(weight, min=1.0)[:, None]
    valid = count > 0
    diff, dist = _distances(f, means, row, in_mask)
    unit = torch.where(dist[:, None] > 0, diff / torch.where(dist > 0, dist, 1.0)[:, None], 0.0)
    dsum = _sum_by(row, dist, M)
    usum = _sum_by(row, unit, M)
    n_valid = valid.sum().to(torch.float32)
    coh = torch.where(valid, dsum / torch.clamp(count, min=1.0), 0.0).sum() / torch.clamp(
        n_valid, min=1.0)
    tables = torch.cat([torch.cat([count[:, None], weight[:, None], sums], 1).reshape(-1),
                        torch.cat([dsum[:, None], usum], 1).reshape(-1), n_valid.reshape(1)])
    return means, valid, coh, tables


def mask_loss_fwd(feat, ids, sil, max_masks: int):
    """feat [H, W, C], ids [H, W] (0 invalid, masks 1..max_masks), sil
    [H, W] (the weights of the means: the silhouette > 0.7) -> (means
    [M, C], valid [M] bool, coh 0-d, tables: `split_tables`'s layout).
    CPU tensors run `mask_loss_fwd_plain`; CUDA tensors launch the
    kernels. `mask_loss_fwd.launches` counts the calls that launched."""
    feat, ids, sil = _inputs("mask_loss_fwd", feat, ids, sil, max_masks)
    if not _device("mask_loss_fwd", feat):
        return mask_loss_fwd_plain(feat, ids, sil, max_masks)
    H, W, C = feat.shape
    M, dev = max_masks, feat.device
    f32 = dict(dtype=torch.float32, device=dev)
    tables = torch.empty(M * (2 * C + 3) + 1, **f32)
    stats, dist, n_valid = split_tables(tables, M, C)
    blocks = -(-H * W // PIXELS_PER_BLOCK)
    part = torch.empty(blocks * M * (C + 2) + 1, **f32)  # the blocks' partials, a counter
    means = torch.empty((M, C), **f32)
    valid = torch.empty(M, dtype=torch.bool, device=dev)
    coh = torch.empty((), **f32)
    _launch("og_mask_loss_fwd", dev, feat.data_ptr(), feat.stride(0), feat.stride(1),
            ids.data_ptr(), sil.data_ptr(), H, W, C, M, part.data_ptr(), stats.data_ptr(),
            means.data_ptr(), valid.data_ptr(), dist.data_ptr(), n_valid.data_ptr(),
            coh.data_ptr())
    mask_loss_fwd.launches += 1
    return means, valid, coh, tables


mask_loss_fwd.launches = 0


def mask_loss_bwd_plain(feat, ids, sil, means, tables, d_coh, d_means):
    """The analytic gradient of the cohesion loss and the means by feat,
    from the forward's tables, by id in plain PyTorch ops."""
    (M, C), (H, W) = means.shape, feat.shape[:2]
    stats, dist_tab, n_valid = split_tables(tables, M, C)
    f = feat.reshape(-1, C)
    row, in_mask = _by_id(ids, M)
    a = (d_coh / torch.clamp(n_valid, min=1.0)) / torch.clamp(stats[:, 0], min=1.0)
    b = (d_means - a[:, None] * dist_tab[:, 1:]) / torch.clamp(stats[:, 1], min=1.0)[:, None]
    diff, dist = _distances(f, means, row, in_mask)
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:1])])  # noqa: E731 (row M: no mask)
    direct = torch.where(dist[:, None] > 0,
                         pad(a)[row][:, None] * diff / torch.where(dist > 0, dist, 1.0)[:, None],
                         0.0)
    return (direct + sil.reshape(-1, 1) * pad(b)[row]).reshape(H, W, C)


def mask_loss_bwd(feat, ids, sil, means, tables, d_coh, d_means):
    """d feat [H, W, C] (contiguous) from d_coh (0-d) and d_means [M, C],
    given the forward's inputs, means and tables. CPU tensors run
    `mask_loss_bwd_plain`; CUDA tensors launch the kernel.
    `mask_loss_bwd.launches` counts the calls that launched."""
    M = means.shape[0]
    feat, ids, sil = _inputs("mask_loss_bwd", feat, ids, sil, M)
    if not _device("mask_loss_bwd", feat):
        return mask_loss_bwd_plain(feat, ids, sil, means, tables, d_coh, d_means)
    H, W, C = feat.shape
    stats, dist, n_valid = split_tables(tables, M, C)
    d_coh = d_coh.to(torch.float32).contiguous()
    d_means = d_means.to(torch.float32).contiguous()
    d_feat = torch.empty((H, W, C), dtype=torch.float32, device=feat.device)
    _launch("og_mask_loss_bwd", feat.device, feat.data_ptr(), feat.stride(0), feat.stride(1),
            ids.data_ptr(), sil.data_ptr(), H, W, C, M, means.data_ptr(), stats.data_ptr(),
            dist.data_ptr(), n_valid.data_ptr(), d_coh.data_ptr(), d_means.data_ptr(),
            d_feat.data_ptr())
    mask_loss_bwd.launches += 1
    return d_feat


mask_loss_bwd.launches = 0


class MaskLoss(torch.autograd.Function):
    """(means, valid, coh) of `mask_loss_fwd`, with `mask_loss_bwd` as the
    backward: the gradient by feat alone (ids, sil and max_masks take none)."""

    @staticmethod
    def forward(ctx, feat, ids, sil, max_masks: int):
        means, valid, coh, tables = mask_loss_fwd(feat, ids, sil, max_masks)
        ctx.save_for_backward(feat, ids, sil, means, tables)
        ctx.mark_non_differentiable(valid)
        return means, valid, coh

    @staticmethod
    def backward(ctx, d_means, _d_valid, d_coh):
        feat, ids, sil, means, tables = ctx.saved_tensors
        return mask_loss_bwd(feat, ids, sil, means, tables, d_coh, d_means), None, None, None


KERNEL_WRAPPERS = (mask_loss_fwd, mask_loss_bwd)
