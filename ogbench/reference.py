"""Plain PyTorch reference of the training steps the benchmark times.

A straightforward implementation of the same mathematics as the system
under test, written from the published 3D Gaussian splatting rasterizer
(Kerbl et al., SIGGRAPH 2023) and the OpenGaussian losses (Wu et al.,
arXiv:2406.02058), with no kernel, cache or fixed budget. It imports
nothing of the program: every number the program derived from the inputs
(the projection, the tile lists, the depth order, the per-splat sums) is
worked out here again from the splats, the views and the optimizer state
that the benchmark made.

  * projection (EWA, the +0.3 pixel dilation, the near plane at 0.2, the
    opacity-aware cutoff radius and the 16x16 tile rectangle), SH colour of
    degree 3, covariance from quaternion and scale;
  * the tile lists, in depth order (ties by splat index), without any cap;
  * the front-to-back blend with its three rules (alpha clamped at 0.99,
    skipped below 1/255, a stop where the transmittance would fall below
    1e-4), written with cumulative products over each tile's list;
  * the photometric loss (L1 and 1 - SSIM, 11x11 Gaussian window) and the
    SAM-mask losses (separation + cohesion over the masks inside the
    silhouette);
  * gradients by autograd through the blend (`blend_grads`), then Adam
    (beta 0.9 / 0.999, eps 1e-15 outside the square root) at the
    schedule's learning rates (`run_steps`).

What a step of each training stage computes from these (which leaves take
gradients, the payload, the loss) is its stage module's
(ogbench/stages/s<id>.py).

The frame is rendered in blocks of tiles, so that it fits at any size: a
first pass without gradients gives the image and the loss's cotangent, a
second pass per block takes the gradients.

`precision="tf32"` is the control: every matrix product (the world-to-camera
transform, the SH contraction, the blend's weighted sum, the SSIM filters,
the mask means) takes its operands rounded to TF32's 10-bit mantissa and
accumulates in float32, as TF32 tensor cores do. `fault="half"` leaves the
lower half of the image out of the loss and takes the mean over the rest
(`loss_rows`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

NEAR_Z = 0.2
DILATION = 0.3
TILE = 16
NPIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
LATE_ITERATION = 35_000  # past it the separation loss weights hard pairs only
SSIM_C1, SSIM_C2 = 0.01**2, 0.03**2
LEAVES = ("means", "sh_dc", "sh_rest", "log_scales", "quats", "logit_opacity",
          "ins_feat")

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

BLOCK_ELEMS = 1 << 25  # (slot, pixel) pairs per block of tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, round to nearest even)."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = (i + 0x0FFF + ((i >> 13) & 1)) & 0xFFFFE000
    i = torch.where(i >= 1 << 31, i - (1 << 32), i)
    return i.to(torch.int32).view(torch.float32)


class _Tf32Einsum(torch.autograd.Function):
    """einsum(eq, a, b) with TF32 operands, forward and backward: each
    product of the backward also takes the incoming gradient and the other
    operand rounded to TF32."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return torch.einsum(eq, tf32(a), tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with torch.enable_grad():
            ra = tf32(a.detach()).requires_grad_(ctx.needs_input_grad[1])
            rb = tf32(b.detach()).requires_grad_(ctx.needs_input_grad[2])
            out = torch.einsum(ctx.eq, ra, rb)
            want = [x for x in (ra, rb) if x.requires_grad]
            got = iter(torch.autograd.grad(out, want, tf32(g)))
        return (None, next(got) if ra.requires_grad else None,
                next(got) if rb.requires_grad else None)


class Arith:
    """The products of one precision: "fp32", or "tf32" (the control)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision must be fp32 or tf32, got {precision!r}")
        self.tf32 = precision == "tf32"

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return _Tf32Einsum.apply(eq, a, b)
        return torch.einsum(eq, a, b)


@contextlib.contextmanager
def no_tf32():
    """PyTorch's own TF32 paths off (float32 products) for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- the per-splat quantities --

def quat_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def covariance(log_scales: torch.Tensor, quats: torch.Tensor, rescale: float = 1.0):
    """Sigma = (R S)(R S)^T, [N, 3, 3]."""
    L = quat_rot(quats) * (torch.exp(log_scales) * rescale)[:, None, :]
    return (L[:, :, None, :] * L[:, None, :, :]).sum(-1)


def sh_colour(ar: Arith, sh: torch.Tensor, means: torch.Tensor, centre: torch.Tensor):
    """Degree-3 SH [N, 16, 3] along the view direction, + 0.5, clamped at 0."""
    d = means - centre
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    basis = torch.stack([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], -1)
    return torch.clamp(ar.ein("nk,nkc->nc", basis, sh) + 0.5, min=0.0)


def feature_colour(ins_feat: torch.Tensor) -> torch.Tensor:
    """(L2-normalised feature + 1) / 2; an all-zero feature stays 0 before the shift."""
    sq = (ins_feat * ins_feat).sum(-1, keepdim=True)
    n = torch.sqrt(torch.where(sq > 0, sq, 1.0))
    return (torch.where(sq > 0, ins_feat / n, 0.0) + 1.0) / 2.0


def project(ar: Arith, cam: dict, means, cov, opacity):
    """-> dict(mean2d [N,2], conic [N,3], opac [N] (0 where culled), rect
    [N,4] tiles x0,x1,y0,y1 (exclusive ends), cull radius [N], depth [N],
    valid [N])."""
    R, tv = cam["R"], cam["t"]
    fx, fy, W, H = cam["fx"], cam["fy"], cam["width"], cam["height"]
    t = ar.ein("nj,ij->ni", means, R) + tv
    tz = t[:, 2]
    front = tz > NEAR_Z
    tzs = torch.where(front, tz, 1.0)
    tanx, tany = W / (2.0 * fx), H / (2.0 * fy)
    txz = torch.clamp(t[:, 0] / tzs, -1.3 * tanx, 1.3 * tanx)
    tyz = torch.clamp(t[:, 1] / tzs, -1.3 * tany, 1.3 * tany)
    iz = 1.0 / tzs
    M0 = (fx * iz)[:, None] * R[0] + (-fx * txz * iz)[:, None] * R[2]
    M1 = (fy * iz)[:, None] * R[1] + (-fy * tyz * iz)[:, None] * R[2]
    M = torch.stack([M0, M1], 1)  # [N, 2, 3]
    MS = (M[:, :, None, :] * cov[:, None, :, :]).sum(-1)
    c2 = (MS[:, :, None, :] * M[:, None, :, :]).sum(-1)
    a, b, c = c2[:, 0, 0] + DILATION, c2[:, 0, 1], c2[:, 1, 1] + DILATION
    det = a * c - b * b
    det_ok = det > 0
    dets = torch.where(det_ok, det, 1.0)
    conic = torch.stack([c / dets, -b / dets, a / dets], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - dets, min=0.1))
    lam = torch.clamp(lam, min=0.0)
    o = torch.clamp(opacity, min=0.0)
    hit = 255.0 * o >= 1.0
    rcut = torch.ceil(torch.sqrt(2.0 * lam * torch.log(torch.clamp(255.0 * o, min=1.0))))
    radius = torch.where(hit, torch.minimum(torch.ceil(3.0 * torch.sqrt(lam)), rcut), 0.0)
    px = ((t[:, 0] / tzs / tanx + 1.0) * W - 1.0) * 0.5
    py = ((t[:, 1] / tzs / tany + 1.0) * H - 1.0) * 0.5
    mean2d = torch.stack([px, py], -1)
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    p, r = mean2d.detach(), radius.detach()

    def tile_of(v, hi):
        return torch.clamp(torch.clamp(v, -2.0**30, 2.0**30).to(torch.int64), 0, hi)

    rect = torch.stack([tile_of((p[:, 0] - r) / TILE, gx),
                        tile_of((p[:, 0] + r + TILE - 1) / TILE, gx),
                        tile_of((p[:, 1] - r) / TILE, gy),
                        tile_of((p[:, 1] + r + TILE - 1) / TILE, gy)], -1)
    area = (rect[:, 1] - rect[:, 0]) * (rect[:, 3] - rect[:, 2])
    valid = front & hit & det_ok & (area > 0)
    return dict(mean2d=mean2d, conic=conic, opac=torch.where(valid, opacity, 0.0),
                rect=rect, cull=torch.where(hit, rcut, 0.0).detach(), depth=tz,
                valid=valid, grid=(gx, gy))


@torch.no_grad()
def tile_lists(proj: dict):
    """Every (splat, tile) pair of the valid splats' rectangles that passes
    the circle-tile test (outside the cutoff radius alpha < 1/255), sorted
    by tile, then depth, then splat. -> (splat [S] int64, tile [S] int64,
    counts [T] int64, starts [T] int64)."""
    rect, valid, mean2d = proj["rect"], proj["valid"], proj["mean2d"].detach()
    gx, gy = proj["grid"]
    dev = rect.device
    idx = torch.nonzero(valid).squeeze(1)
    w = (rect[idx, 1] - rect[idx, 0])
    area = w * (rect[idx, 3] - rect[idx, 2])
    g = torch.repeat_interleave(idx, area)
    first = torch.cumsum(area, 0) - area
    r = torch.arange(g.shape[0], device=dev) - torch.repeat_interleave(first, area)
    ww = torch.repeat_interleave(w, area)
    tx = rect[g, 0] + r % ww
    ty = rect[g, 2] + r // ww
    cx, cy = mean2d[g, 0], mean2d[g, 1]
    x0, y0 = tx.to(torch.float32) * TILE, ty.to(torch.float32) * TILE
    nx = torch.minimum(torch.maximum(cx, x0), x0 + (TILE - 1.0))
    ny = torch.minimum(torch.maximum(cy, y0), y0 + (TILE - 1.0))
    rad = proj["cull"][g]
    keep = (cx - nx) ** 2 + (cy - ny) ** 2 <= rad * rad
    g, tile = g[keep], (ty * gx + tx)[keep]
    n = valid.shape[0]
    order = torch.argsort(proj["depth"].detach(), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    srt = torch.argsort(tile * (n + 1) + rank[g])
    g, tile = g[srt], tile[srt]
    counts = torch.bincount(tile, minlength=gx * gy)
    starts = torch.cumsum(counts, 0) - counts
    return g, tile, counts, starts


def tile_blocks(counts: torch.Tensor, limit: int = BLOCK_ELEMS):
    """Tiles with slots, deepest first, in blocks of at most `limit` (slot,
    pixel) pairs padded to each block's deepest tile. -> [(tiles [Tb], K)]."""
    c = counts.cpu()
    order = torch.argsort(c, descending=True, stable=True)
    order = order[c[order] > 0]
    blocks, i = [], 0
    while i < order.shape[0]:
        k = int(c[order[i]])
        nb = max(1, limit // (k * NPIX))
        blocks.append((order[i:i + nb].to(counts.device), k))
        i += nb
    return blocks


def tile_pixels(tiles: torch.Tensor, gx: int):
    """Pixel coordinates of each tile's 256 pixels (row major), [Tb, 1, 256]."""
    lane = torch.arange(NPIX, device=tiles.device)
    px = (tiles % gx * TILE)[:, None] + lane % TILE
    py = (tiles // gx * TILE)[:, None] + lane // TILE
    return px.to(torch.float32)[:, None, :], py.to(torch.float32)[:, None, :]


def block_alpha(tiles, K, lists, mean2d, conic, opac, gx):
    """The block's slots and alpha after the clamp and the skip.
    -> (slot index [Tb, K] into lists' splats, present [Tb, K], alpha
    [Tb, K, 256])."""
    g, _tile, counts, starts = lists
    k = torch.arange(K, device=tiles.device)
    present = k[None, :] < counts[tiles][:, None]
    pos = torch.where(present, starts[tiles][:, None] + k[None, :], 0)
    ids = g[pos]
    px, py = tile_pixels(tiles, gx)
    m = mean2d[ids]
    cn = conic[ids]
    dx, dy = m[..., 0:1] - px, m[..., 1:2] - py
    power = -0.5 * (cn[..., 0:1] * dx * dx + cn[..., 2:3] * dy * dy) - cn[..., 1:2] * dx * dy
    a = torch.where(power <= 0.0, opac[ids][..., None] * torch.exp(torch.clamp(power, max=0.0)),
                    0.0)
    a = torch.clamp(a, max=ALPHA_MAX)
    a = torch.where((a >= ALPHA_MIN) & present[..., None], a, 0.0)
    return ids, present, a


def walk(a: torch.Tensor):
    """The front-to-back walk of alpha [Tb, K, 256]. -> (contributes [Tb, K,
    256] bool, stop [Tb, 256]: the index of the slot that stops the pixel,
    or K)."""
    with torch.no_grad():
        cum = torch.cumprod(1.0 - a, dim=1)
        below = cum < T_EPS
        stop = torch.where(below.any(1), below.to(torch.int8).argmax(1), a.shape[1])
        contrib = (a > 0) & ~below
    return contrib, stop


def blend_block(ar: Arith, tiles, K, lists, mean2d, conic, opac, payload, gx):
    """-> (accum [Tb, 256, C], final transmittance [Tb, 256]) of one block."""
    ids, _present, a = block_alpha(tiles, K, lists, mean2d, conic, opac, gx)
    contrib, _stop = walk(a)
    b = torch.where(contrib, 1.0 - a, 1.0)
    cb = torch.cumprod(b, dim=1)
    t_before = torch.cat([torch.ones_like(cb[:, :1]), cb[:, :-1]], 1)
    w = torch.where(contrib, a * t_before, 0.0)
    acc = ar.ein("tkp,tkc->tpc", w, payload[ids])
    return acc, cb[:, -1]


def render(ar: Arith, cam: dict, proj: dict, payload: torch.Tensor, bg: torch.Tensor,
           cotangent=None):
    """The frame's payload image [H, W, C] over bg and its alpha [H, W]
    (no gradients); with `cotangent` (dL/dimage, [H, W, C]) instead, run
    each block again with gradients and accumulate into the .grad of the
    leaves mean2d, conic, opac and payload, which must require grad."""
    W, H = cam["width"], cam["height"]
    gx, gy = proj["grid"]
    lists = tile_lists(proj)
    m2, cn, op = proj["mean2d"], proj["conic"], proj["opac"]
    C = payload.shape[1]
    if cotangent is None:
        with torch.no_grad():
            acc = torch.zeros((gx * gy, NPIX, C), device=payload.device)
            tf = torch.ones((gx * gy, NPIX), device=payload.device)
            for tiles, K in tile_blocks(lists[2]):
                a_b, t_b = blend_block(ar, tiles, K, lists, m2, cn, op, payload, gx)
                acc[tiles], tf[tiles] = a_b, t_b
            img = acc + tf[..., None] * bg
            img = img.reshape(gy, gx, TILE, TILE, C).permute(0, 2, 1, 3, 4)
            img = img.reshape(gy * TILE, gx * TILE, C)[:H, :W]
            alpha = (1.0 - tf).reshape(gy, gx, TILE, TILE).permute(0, 2, 1, 3)
            return img, alpha.reshape(gy * TILE, gx * TILE)[:H, :W]
    g = torch.zeros((gy * TILE, gx * TILE, C), device=payload.device)
    g[:H, :W] = cotangent
    g = g.reshape(gy, TILE, gx, TILE, C).permute(0, 2, 1, 3, 4).reshape(gx * gy, NPIX, C)
    g_t = (g * bg).sum(-1)
    for tiles, K in tile_blocks(lists[2]):
        a_b, t_b = blend_block(ar, tiles, K, lists, m2, cn, op, payload, gx)
        torch.autograd.backward([a_b, t_b], [g[tiles], g_t[tiles]])
    return None


# -- losses --

def _band(n: int, device) -> torch.Tensor:
    """[n, n] zero-padded 'same' convolution by the 11-tap Gaussian (sigma 1.5)."""
    g = np.exp(-((np.arange(11) - 5) ** 2) / (2 * 1.5**2))
    g = (g / g.sum()).astype(np.float32)
    m = np.zeros((n, n), np.float32)
    for k in range(11):
        i = np.arange(max(0, 5 - k), min(n, n + 5 - k))
        m[i, i + k - 5] = g[k]
    return torch.as_tensor(m, device=device)


def ssim(ar: Arith, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    H, W, _ = x.shape
    bw, bh = _band(W, x.device), _band(H, x.device)

    def f(z):
        return ar.ein("vhc,uh->uvc", ar.ein("hwc,vw->vhc", z, bw), bh)

    mx, my = f(x), f(y)
    sx, sy, sxy = f(x * x) - mx * mx, f(y * y) - my * my, f(x * y) - mx * my
    m = ((2 * mx * my + SSIM_C1) * (2 * sxy + SSIM_C2)) / (
        (mx * mx + my * my + SSIM_C1) * (sx + sy + SSIM_C2))
    return m.mean()


def rgb_loss(ar: Arith, img, gt, lambda_dssim: float):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (
        1.0 - ssim(ar, img, gt))


def mask_losses(ar: Arith, feat, sil, ids, max_masks: int, iteration: int,
                loss_weight: float):
    """separation + loss_weight * cohesion over SAM ids [H, W] (0 invalid,
    1..max_masks), the means taken inside the silhouette mask sil [H, W]."""
    C = feat.shape[-1]
    f = feat.reshape(-1, C)
    idv = ids.reshape(-1).to(torch.int64)
    onehot = (idv[None, :] == torch.arange(1, max_masks + 1, device=feat.device)[:, None])
    m = onehot.to(torch.float32)
    valid = onehot.any(1)
    ms = m * sil.reshape(1, -1)
    mean = ar.ein("mp,pc->mc", ms, f) / torch.clamp(ms.sum(1), min=1.0)[:, None]
    # cohesion: each pixel's distance to its own mask's mean
    own = torch.clamp(idv - 1, min=0)
    diff = f - mean[own]
    sq = (diff * diff).sum(-1)
    pos = (sq > 0) & (idv > 0)
    dist = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    per = torch.zeros(max_masks, device=feat.device).index_add(0, own, dist)
    per = per / torch.clamp(m.sum(1), min=1.0)
    coh = torch.where(valid, per, 0.0).sum() / torch.clamp(valid.sum(), min=1)
    # separation: inverse squared distances of the means, rank-weighted
    M = max_masks
    nv = valid.sum().to(torch.float32)
    pv = valid[:, None] & valid[None, :]
    d2 = ((mean[:, None, :] - mean[None, :, :]) ** 2).sum(-1)
    eye = torch.eye(M, dtype=torch.bool, device=feat.device)
    inv = torch.where(eye | ~pv, 0.0, 1.0 / (d2 + 1.0))
    key = torch.where(pv & ~eye, inv, -1.0)
    rank = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1,
                         stable=True).to(torch.float32)
    wgt = torch.clamp((rank - (M - nv)) / torch.clamp(nv - 1.0, min=1.0) * 0.9 + 0.1, 0.1, 1.0)
    if iteration > LATE_ITERATION:
        wgt = torch.where(wgt < 0.9, 0.1, wgt)
    sep = (inv * wgt).sum() / torch.clamp(nv * (nv - 1.0), min=1.0)
    return sep + loss_weight * coh


# -- the optimizer --

def expon_lr(step, lr_init, lr_final, delay_mult=1.0, max_steps=1_000_000):
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(opt: dict, it: int, extent: float) -> dict:
    """The 3DGS schedule (position decays log-linearly over 30k steps);
    geometry and appearance frozen past stage 0; ins_feat 1e-4 in stage 2.1."""
    xyz = expon_lr(it, opt["position_lr_init"] * extent, opt["position_lr_final"] * extent,
                   max_steps=opt["position_lr_max_steps"])
    if opt["frozen_init_pts"]:
        xyz = 0.0
    geo = 0.0 if it > opt["start_ins_feat_iter"] else 1.0
    s21 = opt["start_root_cb_iter"] < it <= opt["start_leaf_cb_iter"]
    return dict(means=xyz * geo, sh_dc=opt["feature_lr"] * geo,
                sh_rest=opt["feature_lr"] / 20.0 * geo, log_scales=opt["scaling_lr"] * geo,
                quats=opt["rotation_lr"] * geo, logit_opacity=opt["opacity_lr"] * geo,
                ins_feat=1e-4 if s21 else 1e-3)


def adam(params: dict, grads: dict, mu: dict, nu: dict, count: int, lrs: dict):
    """One Adam step. -> (params, mu, nu), new tensors."""
    c1, c2 = 1.0 - BETA1**count, 1.0 - BETA2**count
    P, Mu, Nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * mu[k] + (1.0 - BETA1) * g
        v = BETA2 * nu[k] + (1.0 - BETA2) * g * g
        P[k] = p - lrs[k] * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        Mu[k], Nu[k] = m, v
    return P, Mu, Nu


# -- one step --

def leaves_of(params: dict) -> dict:
    """Fresh leaves of the parameters that take gradients."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def grads_of(leaves: dict) -> dict:
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in leaves.items()}


def loss_rows(cam: dict, fault: str | None) -> int:
    """The rows of the frame the loss takes: the upper half under
    fault="half", else all."""
    H = cam["height"]
    return H // 2 if fault == "half" else H


def blend_grads(ar: Arith, cam: dict, proj: dict, payload: torch.Tensor, bg: torch.Tensor,
                loss_of) -> float:
    """Render `payload` through `proj` over bg, take loss_of(image, alpha),
    and carry its gradient back through the blend into whatever the
    projection's mean2d, conic and opac and the payload were computed from.
    -> the loss."""
    taps = {k: proj[k].detach().requires_grad_(True) for k in ("mean2d", "conic", "opac")}
    pay = payload.detach().requires_grad_(True)
    view = dict(proj, **taps)
    img, alpha = render(ar, cam, view, pay, bg)
    img = img.requires_grad_(True)
    loss = loss_of(img, alpha)
    (g_img,) = torch.autograd.grad(loss, [img])
    render(ar, cam, view, pay, bg, cotangent=g_img)
    outs = [payload] + [proj[k] for k in taps]
    cots = [pay.grad if pay.grad is not None else torch.zeros_like(pay)] + [
        taps[k].grad if taps[k].grad is not None else torch.zeros_like(taps[k]) for k in taps]
    pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    torch.autograd.backward([o for o, _ in pairs], [c for _, c in pairs])
    return float(loss.detach())


def run_steps(step, params: dict, mu: dict, nu: dict, count: int, views: list, it0: int,
              opt: dict, extent: float, precision: str = "fp32") -> dict:
    """len(views) steps from iteration it0 + 1: step(ar, params, view, it)
    -> (loss, {leaf: gradient}) on each view dict, then Adam.
    -> dict(losses, first_grads, params)."""
    ar = Arith(precision)
    losses, first = [], None
    with no_tf32():
        for j, v in enumerate(views):
            it = it0 + 1 + j
            loss, grads = step(ar, params, v, it)
            if first is None:
                first = grads
            lrs = learning_rates(opt, it, extent)
            with torch.no_grad():
                params, mu, nu = adam(params, grads, mu, nu, count + 1 + j, lrs)
            losses.append(loss)
    return dict(losses=losses, first_grads=first, params=params)
