"""The benchmark's frozen arithmetic: what a training step's data needs, in
operations and bytes, and the card's peaks.

  * `frame_work`: the work of one view's blend, counted from the view's
    own data with the reference's projection and tile lists: the live slots
    and, as (slot, pixel) pairs, what a front-to-back walk that culls by
    each slot's box must do (`evaluated`, `in_box`, `tested`, `blended`),
    and per slot the boxes it stages (`boxes`, `box_tests`). The same
    definitions as the program's plain blend gives them
    (`opengaussian_tpu_torch/ops/rasterize_kernels.py:blend_stream_fwd_plain`
    with count_work), copied here so that a later change to the program
    cannot change what is counted.
  * `fwd_bound`, `bwd_bound`: the least time of the forward blend (K1) and
    of its backward replay (K2) on this card: the larger of the bytes they
    must move over the memory rate and the fp32 operations the frame needs
    over the fp32 rate (`opengaussian_tpu_torch/tools/timing.py`'s
    arithmetic, copied).
  * `blend_ops`, `adam_ops` and the per-splat and per-pixel constants: the
    parts of the fp32 operations a whole step needs: the blend and its
    replay as the bounds count them, the per-splat reduce's adds, the
    per-splat geometry and colour, the loss and Adam, from their shapes.
    Each stage module's `step_ops` (ogbench/stages/) sums its step's.
  * `PEAKS`: NVIDIA's data sheets, fp32 (non-tensor) FLOP/s and HBM
    bytes/s by H100 model.
"""

from __future__ import annotations

import torch

from ogbench import reference as R

# fp32 operations per (slot, pixel) pair of the blend (timing.py's model)
OPS_EVALUATED = 24
OPS_TESTED = 3
OPS_CULL = 4
OPS_BOX = 57
CHUNK = 64  # slots a walk stages at a time
WARP = 32
N_INDEX = 3  # [T] int32 tables a stream blend reads: counts, starts, tile ids

# per-splat operations of the forward geometry: the quaternion's rotation
# (40), the covariance (45), world to camera (15), the Jacobian (10), the 2D
# covariance (68), conic and radii (25), the pixel centre (10); the colour:
# SH degree 3 (dirs 10, basis 45, contraction 96, clamp 3) or the feature
# encoding (20). A backward costs twice its forward.
OPS_GEOMETRY = 223
OPS_SH = 154
OPS_FEATURE = 20
OPS_ADAM = 14  # per parameter element: moments 7, bias corrections 2, the update 5
# per pixel and channel: L1 (3), SSIM's five separable 11-tap filters (220)
# and its formula (20); per pixel: the mask mean (2 C), the cohesion (3 C + 4)
OPS_L1, OPS_SSIM = 3, 240
PARAMS_PER_SPLAT = 3 + 3 + 45 + 3 + 4 + 1 + 6

PEAKS = (("PCIe", 51e12, 2.0e12), ("NVL", 60e12, 3.9e12),
         ("", 67e12, 3.35e12))  # "" = SXM, what "H100 80GB HBM3" names


def peaks(name: str) -> tuple[float, float]:
    """(fp32 FLOP/s, HBM bytes/s) of the H100 model `name`."""
    for key, f, b in PEAKS:
        if key in name and "H100" in name:
            return f, b
    raise ValueError(f"no peaks known for {name!r}")


def ops_blended(C: int) -> int:
    return 1 + 2 * C


def ops_grad(C: int) -> int:
    return 4 * C + 36


def slot_box(g: torch.Tensor) -> torch.Tensor:
    """Each slot's cull box (x0, x1, y0, y1) from its row (mean2d 2, conic 3,
    opacity 1): outside it alpha < 1/255; empty where opacity < 1/255,
    unbounded where no box is safe."""
    mx, my, ca, cb, cc, o = g[..., :6].to(torch.float32).unbind(-1)
    det = (ca.double() * cc.double() - cb.double() * cb.double()).float()
    r = 1e-6 * ((torch.maximum(ca, cc) + cb.abs()) * (ca + cc) / det)
    lvl = (torch.log(o / R.ALPHA_MIN) + 1e-5) / (1.0 - r) * 1.0001
    ex = torch.sqrt(2.0 * lvl * cc / det)
    ey = torch.sqrt(2.0 * lvl * ca / det)
    hx = ex + (ex * 1e-4 + mx.abs() * 2.4e-7 + 0.015625)
    hy = ey + (ey * 1e-4 + my.abs() * 2.4e-7 + 0.015625)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], -1)
    ok = (ca > 0) & (cc > 0) & (det > 0) & (r <= 0.5) & torch.isfinite(box).all(-1)
    inf = float("inf")
    box = torch.where(ok[..., None], box, box.new_tensor([-inf, inf, -inf, inf]))
    return torch.where((o < R.ALPHA_MIN)[..., None], box.new_tensor([inf, -inf, inf, -inf]),
                       box)


@torch.no_grad()
def frame_work(proj: dict) -> dict:
    """The work one view's blend needs (see the module's docstring), from a
    `reference.project` of the view. -> {"live", "tiles", "evaluated",
    "in_box", "tested", "blended", "boxes", "box_tests"} as ints."""
    lists = R.tile_lists(proj)
    counts = lists[2]
    gx, gy = proj["grid"]
    m2, cn, op = proj["mean2d"].detach(), proj["conic"].detach(), proj["opac"].detach()
    rows = torch.cat([m2, cn, op[:, None]], -1)
    work = dict(live=int(counts.sum()), tiles=gx * gy, evaluated=0, in_box=0, tested=0,
                blended=0, boxes=0)
    for tiles, K in R.tile_blocks(counts):
        ids, present, a = R.block_alpha(tiles, K, lists, m2, cn, op, gx)
        contrib, stop = R.walk(a)
        k = torch.arange(K, device=a.device)
        cnt = counts[tiles]
        walked = present[..., None] & (k[None, :, None] <= stop[:, None, :])
        work["evaluated"] += int(walked.sum())
        work["tested"] += int(((a > 0) & walked).sum())
        work["blended"] += int(contrib.sum())
        box = slot_box(rows[ids])  # [Tb, K, 4]
        x0 = (tiles % gx * R.TILE).to(torch.float32)[:, None, None]
        y0 = ((tiles // gx * R.TILE)[:, None]
              + 2 * torch.arange(R.NPIX // WARP, device=a.device)).to(torch.float32)[:, None]
        miss = ((x0 + (R.TILE - 1) < box[..., 0:1]) | (x0 > box[..., 1:2])
                | (y0 + 1 < box[..., 2:3]) | (y0 > box[..., 3:4]))  # [Tb, K, 8]
        meets = (~miss).repeat_interleave(WARP, dim=-1)
        work["in_box"] += int((walked & meets).sum())
        last = stop.max(1).values  # a chunk is staged while a pixel still walks
        c = torch.arange(0, K, CHUNK, device=a.device)
        staged = (c[None, :] < cnt[:, None]) & (last[:, None] >= c[None, :])
        work["boxes"] += int((staged * torch.clamp(cnt[:, None] - c[None, :], max=CHUNK)).sum())
    work["box_tests"] = work["boxes"] * (R.NPIX // WARP)
    return work


def walk_ops(work: dict) -> int:
    return (work["boxes"] * OPS_BOX + work["box_tests"] * OPS_CULL
            + work["in_box"] * OPS_EVALUATED + work["tested"] * OPS_TESTED)


def fwd_cost(work: dict, C: int) -> tuple[int, int]:
    """(bytes, operations) of the forward blend with C payload channels
    (depth included): each live slot's row read once, the index tables, the
    accumulated payload and final transmittance written once."""
    T, F = work["tiles"], 6 + C
    moved = work["live"] * F * 4 + N_INDEX * T * 4 + T * R.NPIX * C * 4 + T * R.NPIX * 4
    return moved, walk_ops(work) + work["blended"] * ops_blended(C)


def bwd_cost(work: dict, C: int) -> tuple[int, int]:
    """(bytes, operations) of the backward replay: the live rows read and
    their gradient rows written once, the index tables, the forward's outputs
    and their cotangents read once."""
    T, F = work["tiles"], 6 + C
    moved = 2 * work["live"] * F * 4 + N_INDEX * T * 4 + 2 * T * R.NPIX * (C + 1) * 4
    ops = walk_ops(work) + work["blended"] * ops_grad(C) + T * R.NPIX * (2 * C + 1)
    return moved, ops


def bound_s(moved: int, ops: int, peak_flops: float, peak_bytes: float) -> float:
    """The least seconds: the larger of the bytes and the operations bounds."""
    return max(moved / peak_bytes, ops / peak_flops)


def blend_ops(work: dict, C: int) -> int:
    """The fp32 operations of the blend with C payload channels, its replay
    and the per-splat reduce of the live rows, given the view's work."""
    return fwd_cost(work, C)[1] + bwd_cost(work, C)[1] + work["live"] * (6 + C)


def adam_ops(capacity: int) -> int:
    """Adam over every parameter element of a table of `capacity` splats."""
    return capacity * PARAMS_PER_SPLAT * OPS_ADAM
