"""Drive the PyTorch port (opengaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA kernel of the port (one nvcc per csrc/*.cu, all
     started together), from the sources in the checkout.
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the streams of a full-width frame (1296x968, 200k splats, SH degree 3,
     6-D instance features): the forward blend K1 at C = 4 (RGB + depth) and
     C = 7 (features + depth); the backward replay K2 and the per-splat
     reduce K3 on the C = 4 stream, with the cotangents of an L1 + SSIM loss
     against the view's image. The dense layout's forward K5, its backward
     K6 and K3 over its rows on the same frame's C = 7 dense block, with the
     cotangents of the stage-1 loss (separation + cohesion on the view's SAM
     masks). Then the rasterizer on the card against the naive oracle on
     the CPU, and at 160x120 one stage-0 step, and one stage-1 and one
     stage-2.1 step in each input layout, on the card against the same
     steps on the CPU.
  4. render path: `opengaussian_tpu_torch.cli.render.main` renders a
     synthetic trained model (written as a PLY) of a 3-view COLMAP scene;
     checks the outputs and that K1 ran on this path. One view rendered
     with pallas_input="dense" equals the stream render.
  5. training path: `opengaussian_tpu_torch.cli.train.main` trains 60
     iterations on the same 3-view scene, whose points3D.bin holds the 200k
     points: 40 stage-0 steps with densify events after steps 20, 30 and 40
     (the first grows the capacity) and an opacity reset after step 30, 10
     stage-1 steps, sweep 1 over the 3 views and the root k-means (k1 = 64),
     10 stage-2.1 steps. Checks that every loss is finite and the stage-0
     loss falls, that the geometry is bit for bit the same in the PLYs saved
     at iterations 40 and 60 while ins_feat moved, that the root codebook is
     saved at iteration 60, that K1 launched 63 times (60 steps + 3 sweep
     views) and K2 and K3 60, and that `cli.render` renders the saved PLY.
     Then the same schedule with RasterizeConfig(pallas_input="dense"): K5
     63, K6 and K3 60, K1 and K2 0, and its first loss equals the stream
     run's.
  6. timings (CUDA events after warm-up), each line with the card's name:
     each kernel against its plain version and its bound, K3's index_add_
     yardstick, the dense block's zero fill, the render, the stage-0 step
     and its phases, the stage-1 and stage-2.1 steps in both layouts, sweep
     1 per view, the root k-means, and torch.profiler's device time by
     kernel over one render of each view and over one step of each stage,
     which give the card's idle share in each.
Then a JSON line of per-kernel numbers, the nvidia-smi line, and last the
result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1296, 968
N_SPLATS = 200_000
N_VIEWS = 3
TRAIN_ITERS = 60
# the iteration each stage ends at: 0 (3DGS), 1 (SAM features), 2.1 (roots)
STAGE_ENDS = dict(start_ins_feat_iter=40, start_root_cb_iter=50, start_leaf_cb_iter=60)
TOL = dict(atol=3e-5, rtol=1e-4)
# K2 and K3 sum many terms (over a tile's pixels; over a splat's slots, in
# atomic order for K3), so their tolerance is relative to each field's
# largest magnitude: |kernel - plain| <= 1e-5 * max|plain field| + 1e-4 * |plain|
GRAD_TOL = dict(norm_atol=1e-5, rtol=1e-4)
# fp32 operations per (slot, pixel) pair of the blend, by what the pair needs:
# every evaluated pair: dx, dy and the conic's quadratic form (11), the clamp
# of power (1), expf (~8: range reduction, ex2 and scaling without fast
# math), the power test, o * gauss, the 0.99 clamp and the 1/255 test (4)
OPS_EVALUATED = 24
OPS_TESTED = 3  # alpha >= 1/255: 1 - alpha, T * (1 - alpha), the 1e-4 test


def ops_blended(C: int) -> int:
    """A pair that composites: w = alpha * T, then a multiply-add per channel."""
    return 1 + 2 * C


def ops_grad(C: int) -> int:
    """A pair that composites, in the backward replay: w (1), gc (2C - 1),
    the running sum (2), 1 - a floored (2), d_alpha (6), the clamp test (1),
    d_power (1), the mean2d, conic and opacity terms (18), the payload terms
    (C) and its share of the sum over the tile's pixels (6 + C)."""
    return 4 * C + 36


# NVIDIA data sheets: fp32 (non-tensor) FLOP/s and HBM bytes/s per H100 model
PEAKS = (("PCIe", 51e12, 2.0e12), ("NVL", 60e12, 3.9e12),
         ("", 67e12, 3.35e12))  # "" = SXM, what "H100 80GB HBM3" names


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def write_model_and_scene(root: str, seed: int = 0) -> tuple[str, str]:
    """A synthetic trained model (PLY) and a 3-view COLMAP scene at
    1296x968: 200k splats with the statistics of bench.py:make_workload
    (create_from_pcd on a seeded cloud, log-scales shifted by log(0.088),
    logit-opacities ~ N(0, 2)), SH degree 3 and seeded 6-D features. The
    scene's points3D.bin holds the same 200k points, which the trainer
    starts from; its cameras sit 1 apart along x (scene extent 1.1)."""
    from PIL import Image

    from opengaussian_tpu_torch.cameras import fov2focal
    from opengaussian_tpu_torch.data import colmap
    from opengaussian_tpu_torch.data.ply import save_gaussian_ply
    from opengaussian_tpu_torch.models.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 1.2, N_SPLATS), rng.normal(0, 0.9, N_SPLATS),
                    rng.uniform(2.0, 10.0, N_SPLATS)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (N_SPLATS, 3)).astype(np.float32)
    s = create_from_pcd(pts, cols, seed=seed, device="cpu")
    n = N_SPLATS
    sh_rest = s.sh_rest.clone()
    sh_rest[:n] = torch.as_tensor(rng.normal(0, 0.1, (n, 15, 3)), dtype=torch.float32)
    logit = s.logit_opacity.clone()
    logit[:n] = torch.as_tensor(rng.normal(0.0, 2.0, n), dtype=torch.float32)
    s = dataclasses.replace(s, sh_rest=sh_rest, logit_opacity=logit,
                            log_scales=s.log_scales + math.log(0.088))
    model = os.path.join(root, "model")
    pc = os.path.join(model, "point_cloud", "iteration_1")
    os.makedirs(pc)
    save_gaussian_ply(os.path.join(pc, "point_cloud.ply"), s)

    scene = os.path.join(root, "scene")
    for d in ("sparse/0", "images", "language_features"):
        os.makedirs(os.path.join(scene, d))
    fx, fy = fov2focal(1.1, WIDTH), fov2focal(0.9, HEIGHT)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", WIDTH, HEIGHT,
                                   np.array([fx, fy, WIDTH / 2, HEIGHT / 2]))}
    imgs = {}
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    for i in range(N_VIEWS):
        ang = 0.06 * (i - 1)  # small yaws about the bench camera
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])
        imgs[i + 1] = colmap.ColmapImage(i + 1, q, np.array([1.0 - i, 0.0, 0.0]), 1,
                                         f"view_{i:03d}.png")
        im = np.stack([xx * 255 // WIDTH, yy * 255 // HEIGHT,
                       np.full_like(xx, 60 * i)], -1).astype(np.uint8)
        Image.fromarray(im).save(os.path.join(scene, "images", f"view_{i:03d}.png"))
        sam = np.zeros((4, HEIGHT, WIDTH), np.int16)
        sam[3] = (xx * 4 // WIDTH + 4 * (yy * 4 // HEIGHT)).astype(np.int16)  # 4x4 masks
        np.save(os.path.join(scene, "language_features", f"view_{i:03d}_s.npy"), sam)
    colmap.write_cameras_binary(cams, os.path.join(scene, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(scene, "sparse/0/images.bin"))
    colmap.write_points3d_binary(pts.astype(np.float64), (cols * 255).astype(np.uint8),
                                 os.path.join(scene, "sparse/0/points3D.bin"))
    return model, scene


def frame_streams(camera, state):
    """The blend inputs of one view's two render passes, built by the
    render path's own _prepare and gather_rows:
    {C: (rows, counts, tstart, toff, grid_x, bins, proj)}."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _prepare, gather_rows
    from opengaussian_tpu_torch.ops.sh import sh_to_rgb
    from opengaussian_tpu_torch.render import encoded_ins_feat

    camera = camera.to(state.device)
    cov3d = build_cov3d(state.scales, state.quats)
    rgb = sh_to_rgb(3, state.sh, state.means, camera.cam_center)
    feat = encoded_ins_feat(state, origin_feat=True)
    out = {}
    for payload in (rgb, feat):
        proj, bins, (gx, _) = _prepare(camera, state.means, cov3d, state.opacity,
                                       RasterizeConfig())
        opac = torch.where(proj.valid, state.opacity, 0.0)
        rows = gather_rows(proj.mean2d, proj.conic, opac,
                           torch.cat([payload, proj.depth[:, None]], dim=-1),
                           bins.sorted_gauss)
        toff = torch.arange(bins.counts.shape[0], dtype=torch.int32,
                            device=state.device)
        out[payload.shape[1] + 1] = (rows, bins.counts, bins.tile_start, toff, gx,
                                     bins, proj)
    return out


def compare(name: str, x: torch.Tensor, y: torch.Tensor, atol, rtol) -> float:
    """Raise unless |x - y| <= atol + rtol |y| everywhere (atol may be a
    tensor that broadcasts); -> the largest absolute error."""
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (x - y).abs()
    bad = err > atol + rtol * y.abs()
    e = float(err.max()) if err.numel() else 0.0
    log(f"kernel {name}: max_abs_err={e:.3e} out_of_tol={int(bad.sum())}")
    if bool(bad.any()):
        i = int(torch.argmax(torch.where(bad, err, 0.0)))
        idx = np.unravel_index(i, tuple(x.shape))
        raise AssertionError(f"{name} disagrees with the plain version at {idx}: "
                             f"kernel {float(x.flatten()[i])!r} plain "
                             f"{float(y.flatten()[i])!r}")
    return e


def grad_atol(y: torch.Tensor) -> torch.Tensor:
    """GRAD_TOL's absolute part: a fraction of each field's largest value."""
    return GRAD_TOL["norm_atol"] * y.abs().amax(dim=0, keepdim=True)


def check_kernel_against_plain(streams, chunk: int) -> tuple[float, dict]:
    """blend_stream_fwd (CUDA) against blend_stream_fwd_plain at each C.
    -> (max abs error, {C: the plain version's work counts})."""
    from opengaussian_tpu_torch.ops.rasterize_kernels import (
        blend_stream_fwd,
        blend_stream_fwd_plain,
    )

    worst, work = 0.0, {}
    for C, (rows, counts, tstart, toff, gx, *_rest) in streams.items():
        acc, t_final = blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)
        torch.cuda.synchronize()
        acc_p, t_p, work[C] = blend_stream_fwd_plain(rows, counts, tstart, toff, gx,
                                                     chunk, count_work=True)
        log(f"work C={C}: " + ", ".join(f"{k} {v}" for k, v in work[C].items()))
        for name, x, y in (("accum", acc, acc_p), ("t_final", t_final, t_p)):
            worst = max(worst, compare(f"blend_stream_fwd C={C} {name}", x, y,
                                       TOL["atol"], TOL["rtol"]))
    return worst, work


def loss_cotangents(camera, grids, stream, chunk, gt):
    """g_accum, g_t of the stage-0 loss (L1 + SSIM, lambda 0.2) of this
    frame's color image against `gt`, through the render path's own
    _images. -> (accum, t_final, g_accum, g_t)."""
    from opengaussian_tpu_torch.ops.rasterize import _images
    from opengaussian_tpu_torch.ops.rasterize_kernels import blend_stream_fwd
    from opengaussian_tpu_torch.train.losses import rgb_loss

    rows, counts, tstart, toff, gx, *_ = stream
    accum, t_final = blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)
    a = accum.clone().requires_grad_(True)
    t = t_final.clone().requires_grad_(True)
    image, _, _ = _images(camera, grids, a, t, torch.zeros(3, device=a.device))
    g_accum, g_t = torch.autograd.grad(rgb_loss(image, gt), (a, t))
    return accum, t_final, g_accum.contiguous(), g_t.contiguous()


def check_grad_kernels(stream, cot, chunk: int, n: int) -> dict:
    """blend_stream_bwd (K2) and segment_reduce (K3) against their plain
    versions on the card, on one frame's stream and loss cotangents.
    -> {"k2_err", "k3_err", "work", "d_rows"}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    rows, counts, tstart, toff, gx, bins, _ = stream
    args = (rows, counts, tstart, toff, *cot, gx, chunk)
    d = rk.blend_stream_bwd(*args)
    torch.cuda.synchronize()
    d_p, work = rk.blend_stream_bwd_plain(*args, count_work=True)
    log("work K2: " + ", ".join(f"{k} {v}" for k, v in work.items()))
    k2 = compare("blend_stream_bwd C=4 d_rows", d, d_p, grad_atol(d_p), GRAD_TOL["rtol"])
    if float(d_p.abs().max()) == 0.0:
        raise AssertionError("K2: the loss gave no gradient")
    per = rk.segment_reduce(d_p, bins.sorted_gauss, n)
    torch.cuda.synchronize()
    per_p = rk.segment_reduce_plain(d_p, bins.sorted_gauss, n)
    k3 = compare("segment_reduce per-splat", per, per_p, grad_atol(per_p),
                 GRAD_TOL["rtol"])
    return dict(k2_err=k2, k3_err=k3, work=work, d_rows=d_p)


def check_against_oracle(dev):
    """The rasterizer on the card against the naive per-pixel oracle on the
    CPU, on a small scene (the repo's own reference)."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.ops.oracle import rasterize_oracle
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

    rng = np.random.default_rng(7)
    n = 600
    means = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.6, n),
                      rng.permutation(np.linspace(2.0, 6.0, n))], -1)
    arrs = [means, np.exp(rng.normal(-2.5, 0.4, (n, 3))), rng.normal(size=(n, 4)),
            rng.uniform(0.1, 0.95, n), rng.uniform(size=(n, 3))]
    means, scales, quats, op, cols = (torch.as_tensor(a, dtype=torch.float32) for a in arrs)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 160, 120)
    bg = torch.tensor([0.2, 0.1, 0.4])
    cov = build_cov3d(scales, quats)
    cfg = RasterizeConfig(tight_radius=False)
    with torch.no_grad():
        r = rasterize(cam, *(x.to(dev) for x in (means, cov, op, cols, bg)), cfg)
    o = rasterize_oracle(cam, means, cov, op, cols, bg)
    for k, x in (("image", r.image), ("alpha", r.alpha), ("depth", r.depth)):
        tol = dict(atol=3e-4, rtol=1e-4) if k == "depth" else TOL
        torch.testing.assert_close(x.cpu(), o[k], **tol, msg=lambda m: f"{k}: {m}")
    if not torch.equal(r.radii.cpu(), o["radii"]):
        raise AssertionError("radii disagree with the oracle")
    log(f"oracle: 160x120, {n} splats: image/alpha/depth/radii agree")


def check_step_against_cpu(dev):
    """One stage-0 step at 160x120 on the card (K1, K2, K3) against the same
    step on the CPU (their plain versions): loss, every new parameter and
    Adam moment to a normalised 1e-3, denom and max_radii2d exactly."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.train import loop

    rng = np.random.default_rng(11)
    n = 600
    pts = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.5, n),
                    rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    gt = rng.uniform(0.2, 0.8, (1, 120, 160, 3)).astype(np.float32)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 160, 120)
    outs = []
    for d in (torch.device("cpu"), dev):
        st = G.create_from_pcd(pts, cols, capacity=1024, device=d)
        t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
        bundle = loop.ViewBundle(
            R=t(cam.R_w2c)[None], t=t(cam.t_w2c)[None], fx=t(cam.fx)[None],
            fy=t(cam.fy)[None], cx=t(cam.cx)[None], cy=t(cam.cy)[None],
            gt_images=t(gt), alpha_masks=torch.ones((1, 120, 160), device=d),
            has_alpha=torch.zeros(1, dtype=torch.bool, device=d),
            sam_ids=torch.zeros((1, 120, 160), dtype=torch.int32, device=d),
            width=160, height=120, max_masks=8)
        outs.append(loop.stage0_step(
            st, opt_mod.init(st.params()), G.DensifyStats.zeros(1024, d), bundle, 0, 1,
            torch.zeros(3, device=d), 1.0, RasterizeConfig(), OptimizationConfig()))
    (s_c, a_c, st_c, l_c, *_), (s_g, a_g, st_g, l_g, *_) = outs
    if not math.isclose(float(l_g), float(l_c), rel_tol=1e-4):
        raise AssertionError(f"step loss: card {float(l_g)} cpu {float(l_c)}")
    worst = 0.0
    for name, got, want in ([(f"param {k}", getattr(s_g, k), getattr(s_c, k))
                             for k in G.PARAM_FIELDS]
                            + [(f"mu {k}", a_g.mu[k], a_c.mu[k]) for k in G.PARAM_FIELDS]
                            + [(f"nu {k}", a_g.nu[k], a_c.nu[k]) for k in G.PARAM_FIELDS]):
        g, w = got.cpu(), want
        scale = max(float(w.abs().max()), 1e-12)
        e = float((g - w).abs().max()) / scale
        worst = max(worst, e)
        if not bool(torch.isfinite(g).all()) or e > 1e-3:
            raise AssertionError(f"step {name}: normalised error {e:.3e}")
    for f in ("denom", "max_radii2d"):
        if not torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)):
            raise AssertionError(f"step stats {f} differ between card and CPU")
    e_acc = float((st_g.grad_accum.cpu() - st_c.grad_accum).abs().max())
    log(f"step: 160x120, {n} splats: loss {float(l_g):.6f} (cpu {float(l_c):.6f}), "
        f"params and moments agree to a normalised {worst:.2e}, denom and "
        f"max_radii2d equal, grad_accum max err {e_acc:.2e}")


def fitted_max_per_tile(deepest: int, chunk: int) -> int:
    """max_per_tile as the trainer fits it to a frame's deepest tile
    (Trainer._fit_max_per_tile): 1.3x the deepest tile, rounded up to the
    chunk, never below the default."""
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.train.loop import HEADROOM

    return max(RasterizeConfig().max_per_tile, -(-int(deepest * HEADROOM) // chunk) * chunk)


def frame_dense(camera, state, max_per_tile: int):
    """The feature pass's dense block of one view, built by the render path's
    own _prepare (pallas_input="dense") and gather_rows: C = 7 (6-D
    features + depth). -> (gdata [T, K, 13], counts, gauss_idx, grid_x,
    n_truncated)."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _prepare, gather_rows
    from opengaussian_tpu_torch.render import encoded_ins_feat

    camera = camera.to(state.device)
    cfg = RasterizeConfig(max_per_tile=max_per_tile, pallas_input="dense")
    proj, bins, (gx, _) = _prepare(camera, state.means, build_cov3d(state.scales, state.quats),
                                   state.opacity, cfg)
    opac = torch.where(proj.valid, state.opacity, 0.0)
    payload = torch.cat([encoded_ins_feat(state, origin_feat=True), proj.depth[:, None]], -1)
    gdata = gather_rows(proj.mean2d, proj.conic, opac, payload, bins.gauss_idx)
    return gdata, bins.counts, bins.gauss_idx, gx, int(bins.n_truncated)


def stage1_cotangents(camera, grids, accum, t_final, sam_ids, max_masks: int,
                      loss_weight: float):
    """g_accum, g_t of the stage-1 loss of this feature pass, as stage1_step
    takes it: separation + loss_weight * cohesion on the view's SAM masks,
    with the mask means inside the silhouette > 0.7, through the render
    path's own _images."""
    from opengaussian_tpu_torch.ops.rasterize import _images
    from opengaussian_tpu_torch.train import losses
    from opengaussian_tpu_torch.utils import masks as masku

    a = accum.clone().requires_grad_(True)
    t = t_final.clone().requires_grad_(True)
    feat, sil, _ = _images(camera, grids, a, t, torch.zeros(6, device=a.device))
    masks, valid = masku.masks_onehot(sam_ids, max_masks)
    means = masku.mask_feature_mean(feat, masks, image_mask=(sil > 0.7).to(torch.float32))
    loss = (losses.separation_loss(means, valid, STAGE_ENDS["start_ins_feat_iter"] + 1)
            + loss_weight * losses.cohesion_loss(feat, masks, valid, means))
    g_accum, g_t = torch.autograd.grad(loss, (a, t))
    return g_accum.contiguous(), g_t.contiguous()


def check_dense_kernels(block, camera, grids, sam_ids, max_masks: int, chunk: int,
                        n: int) -> dict:
    """blend_tiles_fwd (K5), blend_tiles_bwd (K6) and segment_reduce (K3)
    over the block's rows against their plain versions on the card, with
    stage-1 cotangents. -> {"k5_err", "k6_err", "k3_err", "work_fwd",
    "work_bwd", "cot", "ids"}."""
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    gdata, counts, gauss_idx, gx, _ = block
    T, K, F = gdata.shape
    acc, t_final = rk.blend_tiles_fwd(gdata, counts, gx, chunk)
    torch.cuda.synchronize()
    acc_p, t_p, work_f = rk.blend_tiles_fwd_plain(gdata, counts, gx, chunk, count_work=True)
    log("work K5: " + ", ".join(f"{k} {v}" for k, v in work_f.items()))
    k5 = max(compare(f"blend_tiles_fwd C={F - 6} {nm}", x, y, TOL["atol"], TOL["rtol"])
             for nm, x, y in (("accum", acc, acc_p), ("t_final", t_final, t_p)))
    cot = stage1_cotangents(camera, grids, acc_p, t_p, sam_ids, max_masks,
                            OptimizationConfig().loss_weight)
    args = (gdata, counts, acc_p, t_p, *cot, gx, chunk)
    d = rk.blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    d_p, work_b = rk.blend_tiles_bwd_plain(*args, count_work=True)
    log("work K6: " + ", ".join(f"{k} {v}" for k, v in work_b.items()))
    rows, rows_p = d.view(T * K, F), d_p.view(T * K, F)
    k6 = compare(f"blend_tiles_bwd C={F - 6} d_slot", rows, rows_p, grad_atol(rows_p),
                 GRAD_TOL["rtol"])
    if float(rows_p.abs().max()) == 0.0:
        raise AssertionError("K6: the stage-1 loss gave no gradient")
    live = torch.arange(K, device=counts.device)[None, :] < counts[:, None]
    ids = torch.where(live, gauss_idx, n).to(torch.int32).view(T * K)
    per = rk.segment_reduce(rows_p, ids, n)
    torch.cuda.synchronize()
    per_p = rk.segment_reduce_plain(rows_p, ids, n)
    k3 = compare("segment_reduce per-splat (dense rows)", per, per_p, grad_atol(per_p),
                 GRAD_TOL["rtol"])
    return dict(k5_err=k5, k6_err=k6, k3_err=k3, work_fwd=work_f, work_bwd=work_b,
                cot=cot, ids=ids)


def to_device(x, dev):
    """A frozen dataclass of tensors (GaussianState, KMeansState) on dev."""
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).to(dev)
                                     for f in dataclasses.fields(x)})


def check_feature_steps_against_cpu(dev):
    """At 160x120, one stage-1 step and one stage-2.1 step in each input
    layout on the card (K1/K2 or K5/K6, and K3) against the same step on the
    CPU (the plain versions): the loss to 1e-4, ins_feat and its Adam
    moments to a normalised 1e-3, the geometry unchanged bit for bit on the
    card, and each layout through its own kernels."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.train import loop
    from opengaussian_tpu_torch.train.pseudo import construct_pseudo_labels

    W, H, n = 160, 120, 600
    rng = np.random.default_rng(12)
    pts = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.5, n),
                    rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    sam = 1 + xx // 40 + 4 * (yy // 60)  # 8 masks, 10% of the pixels invalid
    sam = np.where(rng.uniform(size=(H, W)) < 0.1, 0, sam).astype(np.int32)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    base = G.create_from_pcd(pts, cols, capacity=1024, device="cpu")
    logit = base.logit_opacity.clone()
    logit[:n] = torch.as_tensor(rng.normal(1.0, 1.0, n), dtype=torch.float32)
    base = dataclasses.replace(base, logit_opacity=logit)  # silhouettes past 0.7
    kms = km.assign_root(km.KMeansState.create(1024, 8, 5, "cpu"), base.ins_feat,
                         base.means, base.alive, 1.0,
                         torch.Generator().manual_seed(0), init=True)
    pseudo = construct_pseudo_labels(base, [cam], torch.as_tensor(sam)[None],
                                     torch.zeros(3), 8, RasterizeConfig()).feat[0]
    ocfg = OptimizationConfig()
    kernels = {"stream": (rk.blend_stream_fwd, rk.blend_stream_bwd),
               "dense": (rk.blend_tiles_fwd, rk.blend_tiles_bwd)}
    for layout, (fwd, bwd) in kernels.items():
        rcfg = RasterizeConfig(pallas_input=layout)
        for stage in ("1", "2.1"):
            outs = []
            for d in (torch.device("cpu"), dev):
                t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
                bundle = loop.ViewBundle(
                    R=t(cam.R_w2c)[None], t=t(cam.t_w2c)[None], fx=t(cam.fx)[None],
                    fy=t(cam.fy)[None], cx=t(cam.cx)[None], cy=t(cam.cy)[None],
                    gt_images=torch.zeros((1, H, W, 3), device=d),
                    alpha_masks=torch.ones((1, H, W), device=d),
                    has_alpha=torch.zeros(1, dtype=torch.bool, device=d),
                    sam_ids=t(sam)[None], width=W, height=H, max_masks=8)
                st = to_device(base, d)
                before = (fwd.launches, bwd.launches)
                if stage == "1":
                    out = loop.stage1_step(st, opt_mod.init(st.params()), bundle, 0,
                                           STAGE_ENDS["start_ins_feat_iter"] + 1,
                                           torch.zeros(3, device=d), 1.0, rcfg, ocfg)
                else:
                    out = loop.stage21_step(st, opt_mod.init(st.params()), to_device(kms, d),
                                            bundle, 0, STAGE_ENDS["start_root_cb_iter"] + 1,
                                            torch.zeros(3, device=d), 0.7, pseudo.to(d),
                                            rcfg, ocfg)
                torch.cuda.synchronize()
                outs.append((st, out, (fwd.launches - before[0], bwd.launches - before[1])))
            (_, (s_c, a_c, l_c, _), _), (st_g, (s_g, a_g, l_g, lost_g), launched) = outs
            what = f"stage-{stage} step, {layout} layout"
            if launched != (1, 1):
                raise AssertionError(f"{what}: launches of {fwd.__name__}, "
                                     f"{bwd.__name__} {launched}, expected (1, 1)")
            if int(lost_g) != 0 or not math.isclose(float(l_g), float(l_c), rel_tol=1e-4):
                raise AssertionError(f"{what}: loss card {float(l_g)} cpu {float(l_c)}, "
                                     f"{int(lost_g)} slots lost")
            worst = 0.0
            for name, got, want in (("ins_feat", s_g.ins_feat, s_c.ins_feat),
                                    ("mu", a_g.mu["ins_feat"], a_c.mu["ins_feat"]),
                                    ("nu", a_g.nu["ins_feat"], a_c.nu["ins_feat"])):
                e = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-12)
                worst = max(worst, e)
                if not bool(torch.isfinite(got).all()) or e > 1e-3:
                    raise AssertionError(f"{what}: {name} normalised error {e:.3e}")
            for k in G.PARAM_FIELDS:
                if k != "ins_feat" and not torch.equal(getattr(s_g, k), getattr(st_g, k)):
                    raise AssertionError(f"{what}: the step changed {k}")
            if torch.equal(s_g.ins_feat, st_g.ins_feat):
                raise AssertionError(f"{what}: ins_feat did not move")
            log(f"{what}: 160x120, {n} splats: loss {float(l_g):.6f} (cpu "
                f"{float(l_c):.6f}), ins_feat and its moments agree to a normalised "
                f"{worst:.2e}, geometry unchanged")


def profile(fn, n: int, what: str) -> tuple[float, float]:
    """torch.profiler over n calls of fn: device time by kernel.
    -> (device busy ms per call, the union of the kernels' intervals; host
    wall ms per call of the same profiled calls, to the last kernel's end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    busy_ms = busy / 1e3 / n
    span_ms = (end - kernels[0].time_range.start) / 1e3 / n
    log(f"profile {what}: device busy {busy_ms:.3f} ms, first kernel start to last "
        f"kernel end {span_ms:.3f} ms, host wall {wall_ms:.3f} ms, "
        f"{len(kernels) / n:.0f} kernel launches (per {what})")
    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile {what}:   {us / 1e3 / n:8.4f} ms  {k[:90]}")
    return busy_ms, wall_ms


def fwd_bound(name, live: int, F: int, T: int, n_index: int, work, peak_flops,
              peak_bytes) -> tuple[float, str]:
    """A forward blend's least time per launch (K1, K5): the larger of the
    bytes moved over the HBM rate (each of the `live` slot rows read once,
    n_index [T] int32 tables, accum and t_final written once) and the
    operations this frame's data needs (from the plain version's work
    counts) over the fp32 rate."""
    C = F - 6
    moved = live * F * 4 + n_index * T * 4 + T * 256 * C * 4 + T * 256 * 4
    ops = (work["evaluated"] * OPS_EVALUATED + work["tested"] * OPS_TESTED
           + work["blended"] * ops_blended(C))
    return bound_of(name, moved, ops, peak_flops, peak_bytes)


def bound_of(name, moved, ops, peak_flops, peak_bytes) -> tuple[float, str]:
    t_bytes, t_ops = moved / peak_bytes * 1e3, ops / peak_flops * 1e3
    log(f"bound: {name}: {moved} bytes -> {t_bytes:.4f} ms, {ops} ops -> {t_ops:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bwd_bound(name, live: int, F: int, T: int, n_index: int, work, peak_flops,
              peak_bytes) -> tuple[float, str]:
    """A backward replay's (K2, K6): the live rows read and their gradient
    rows written once, n_index [T] int32 tables, accum/g_accum/t_final/g_t
    read once; the replay's operations from its own pair counts."""
    C = F - 6
    moved = 2 * live * F * 4 + n_index * T * 4 + 2 * T * 256 * (C + 1) * 4
    ops = (work["evaluated"] * OPS_EVALUATED + work["tested"] * OPS_TESTED
           + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1))
    return bound_of(name, moved, ops, peak_flops, peak_bytes)


def reduce_bound(d_rows, n, peak_flops, peak_bytes) -> tuple[float, str]:
    """K3: rows and ids read once, [n, F] written once; one add per element."""
    R, F = d_rows.shape
    return bound_of("segment_reduce", R * F * 4 + R * 4 + n * F * 4, R * F,
                    peak_flops, peak_bytes)


def launch_counts() -> dict:
    """{wrapper: the module attribute whose .launches it counts}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    return {w: getattr(rk, w) for w in ("blend_stream_fwd", "blend_stream_bwd",
                                        "segment_reduce", "blend_tiles_fwd",
                                        "blend_tiles_bwd")}


def train_path(scene_dir: str, root: str, dev, rcfg=None) -> tuple:
    """The training main path: cli.train.main for TRAIN_ITERS iterations
    through stages 0, 1 and 2.1 (rcfg: the rasterizer's settings, None for
    the default stream layout), every kernel's launches counted around it.
    Checks the launches, the losses, the geometry across the feature stages
    and the root codebook. -> (trainer, {kernel: launches}, output dir)."""
    from opengaussian_tpu_torch.cli import train as cli_train
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply
    from opengaussian_tpu_torch.utils.codebook import load_codebook

    layout = rcfg.pallas_input if rcfg is not None else "stream"
    out = os.path.join(root, f"trained_{layout}")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    flags = [x for k, v in STAGE_ENDS.items() for x in (f"--{k}", str(v))]
    tr = cli_train.main(
        ["-s", scene_dir, "-m", out, "--iterations", str(TRAIN_ITERS), *flags,
         "--densify_from_iter", "10", "--densification_interval", "10",
         "--opacity_reset_interval", "30"], device=dev, rcfg=rcfg)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    what = f"training path ({layout})"
    log(f"{what}: {TRAIN_ITERS} iterations in {time.perf_counter() - t0:.2f} s "
        f"(scene load, setup, sweep 1 and saves included), launches {launches}")
    fwd, bwd = (("blend_tiles_fwd", "blend_tiles_bwd") if layout == "dense"
                else ("blend_stream_fwd", "blend_stream_bwd"))
    want = dict.fromkeys(wrappers, 0)
    want[fwd] = TRAIN_ITERS + tr.bundle.num_views  # every step, and sweep 1's views
    want[bwd] = want["segment_reduce"] = TRAIN_ITERS
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")
    losses = torch.stack(tr.losses).cpu().numpy()
    log(f"{what}: loss by step " + " ".join(f"{x:.5f}" for x in losses))
    if not np.isfinite(losses).all():
        raise AssertionError(f"{what}: a loss is not finite")
    # the opacity reset after step 30 clamps every opacity to 0.01, which
    # raises the loss again: compare the stage-0 steps before it
    m = [float(losses[i:i + 10].mean()) for i in range(0, TRAIN_ITERS, 10)]
    if not m[2] < m[0]:
        raise AssertionError(f"{what}: loss did not fall: mean of steps 1-10 {m[0]}, "
                             f"of steps 21-30 {m[2]}")
    log(f"{what}: mean loss of steps 1-10, ..., 51-60: "
        + ", ".join(f"{x:.5f}" for x in m)
        + f"; capacity {tr.state.capacity}, alive {int(tr.state.num_alive)}, "
        f"max_per_tile {tr.rcfg.max_per_tile}, slots lost in the last step "
        f"{int(tr._last_lost)}")
    if tr.state.capacity <= N_SPLATS + 4096:
        raise AssertionError(f"{what}: the capacity did not grow")
    # past stage 0 only ins_feat learns: the PLYs of iterations 40 and 60
    pc = os.path.join(out, "point_cloud")
    ply = {it: load_gaussian_ply(os.path.join(pc, f"iteration_{it}", "point_cloud.ply"))
           for it in (STAGE_ENDS["start_ins_feat_iter"], TRAIN_ITERS)}
    a, b = ply.values()
    for k in ("means", "sh_dc", "sh_rest", "log_scales", "quats", "logit_opacity"):
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} changed in the feature stages")
    moved = float(np.abs(a["ins_feat"] - b["ins_feat"]).max())
    if not moved > 0:
        raise AssertionError(f"{what}: ins_feat did not move in the feature stages")
    centers, ids = load_codebook(os.path.join(pc, f"iteration_{TRAIN_ITERS}",
                                              "root_code_book"))
    n_alive = int(tr.state.num_alive)
    if centers.shape != (tr.cfg.opt.root_node_num, 9) or len(ids) != n_alive:
        raise AssertionError(f"{what}: root codebook {centers.shape}, {len(ids)} ids "
                             f"for {n_alive} splats")
    log(f"{what}: geometry bit for bit equal at iterations "
        f"{STAGE_ENDS['start_ins_feat_iter']} and {TRAIN_ITERS} ({len(a['means'])} "
        f"splats), ins_feat moved up to {moved:.4f}; root codebook {centers.shape[0]} "
        f"centers, {len(np.unique(ids))} of them used, one id per alive splat")
    return tr, launches, out


def check_trained_render(out: str, scene_dir: str, dev) -> int:
    """cli.render on the trained model's last PLY: every render non-empty.
    -> views rendered."""
    from PIL import Image

    from opengaussian_tpu_torch.cli import render as cli_render

    n = cli_render.main(["-m", out, "-s", scene_dir], device=dev)
    for split in ("train", "test"):
        d = os.path.join(out, split, "ours", "renders")
        for f in sorted(os.listdir(d)) if os.path.isdir(d) else []:
            if np.asarray(Image.open(os.path.join(d, f))).max() == 0:
                raise AssertionError(f"{d}/{f}: an empty render of the trained model")
    log(f"training path: cli.render rendered the iteration-{TRAIN_ITERS} PLY, {n} views")
    return n


def time_step(tr, card: str) -> dict:
    """Stage-0 step time (10 steps between two CUDA events), and the time of
    its phases (each phase between its own events, over 10 steps)."""
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.train import loop, losses

    it0 = STAGE_ENDS["start_ins_feat_iter"]  # a stage-0 iteration: geometry learns

    def step(i):
        tr.state, tr.adam, tr.stats, *_ = loop.stage0_step(
            tr.state, tr.adam, tr.stats, tr.bundle, i % tr.bundle.num_views,
            it0, tr.bg, tr.spatial_lr_scale, tr.rcfg, tr.cfg.opt)

    step(0)
    i = iter(range(1, 1000))
    step_ms = cuda_ms(lambda: step(next(i)), iters=10, warmup=0)
    log(f"timing: stage-0 step {step_ms:.3f} ms (capacity {tr.state.capacity}, "
        f"{int(tr.state.num_alive)} alive, {WIDTH}x{HEIGHT}) [{card}]")

    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    phases = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "adam": 0.0}
    n = 10
    for k in range(n):
        vi = k % tr.bundle.num_views
        e = [ev() for _ in range(5)]
        e[0].record()
        params = {k2: v.detach().requires_grad_(True) for k2, v in tr.state.params().items()}
        tap = torch.zeros((tr.state.capacity, 2), device=tr.device, requires_grad=True)
        gs = loop._mask_sh(tr.state.with_params(params), it0)
        out = loop.render(tr.bundle.camera(vi), gs, tr.bg, 3, tr.rcfg, screen_tap=tap)
        e[1].record()
        loss = losses.rgb_loss(out.render, tr.bundle.gt_images[vi], tr.cfg.opt.lambda_dssim)
        e[2].record()
        leaves = list(params.values()) + [tap]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        e[3].record()
        lrs = opt_mod.learning_rates(tr.cfg.opt, it0, tr.spatial_lr_scale)
        opt_mod.apply(tr.state.params(), dict(zip(params, grads[:-1])), tr.adam, lrs)
        e[4].record()
        torch.cuda.synchronize()
        for j, name in enumerate(phases):
            phases[name] += e[j].elapsed_time(e[j + 1]) / n
    log("timing: stage-0 step phases: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in phases.items())
        + " (forward: SH, project, bin, K1; loss: L1 + SSIM; backward: K2, K3 and "
        f"autograd of the rest; adam: the update) [{card}]")
    busy, wall = profile(lambda: step(next(i)), 1, "stage-0 step")
    log(f"timing: device idle share during the profiled stage-0 step "
        f"{1.0 - busy / wall:.3f} (busy {busy:.3f} of {wall:.3f} ms, both from that "
        f"run) [{card}]")
    return dict(step_ms=step_ms, **phases, busy=busy, wall=wall)


def time_feature_stages(tr, card: str) -> None:
    """From the trained state: the stage-1 and stage-2.1 step in both input
    layouts (10 steps between two CUDA events; each step's result is
    dropped, so every step starts from the same state), torch.profiler over
    one stage-1 step of each layout, sweep 1 per view in both layouts, and
    the root k-means at k1, fresh (the entry to stage 2.1) and against the
    cached centers (every 200 iterations)."""
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.train import loop
    from opengaussian_tpu_torch.train.pseudo import construct_pseudo_labels

    o, V = tr.cfg.opt, tr.bundle.num_views
    cams = [tr.bundle.camera(v) for v in range(V)]
    for layout in ("stream", "dense"):
        rcfg = dataclasses.replace(tr.rcfg, pallas_input=layout)

        def s1(i, rcfg=rcfg):
            loop.stage1_step(tr.state, tr.adam, tr.bundle, i % V, o.start_ins_feat_iter + 1,
                             tr.bg, 1.0, rcfg, o, tr.any_alpha)

        def s21(i, rcfg=rcfg):
            loop.stage21_step(tr.state, tr.adam, tr.kms, tr.bundle, i % V,
                              o.start_root_cb_iter + 1, tr.bg, 1.0, tr.pseudo.feat[i % V],
                              rcfg, o, tr.any_alpha)

        for stage, fn in (("1", s1), ("2.1", s21)):
            i = iter(range(1000))
            ms = cuda_ms(lambda: fn(next(i)), iters=10)
            log(f"timing: stage-{stage} step, {layout} layout: {ms:.3f} ms (capacity "
                f"{tr.state.capacity}, {int(tr.state.num_alive)} alive, max_per_tile "
                f"{rcfg.max_per_tile}) [{card}]")
        busy, wall = profile(lambda: s1(0), 1, f"stage-1 step ({layout})")
        log(f"timing: device idle share during the profiled stage-1 step ({layout}) "
            f"{1.0 - busy / wall:.3f} (busy {busy:.3f} of {wall:.3f} ms) [{card}]")
        ms = cuda_ms(lambda: construct_pseudo_labels(tr.state, cams, tr.bundle.sam_ids, tr.bg,
                                                     tr.bundle.max_masks, rcfg), iters=2)
        log(f"timing: sweep 1, {layout} layout: {ms / V:.3f} ms per view [{card}]")
    gen = torch.Generator(device=tr.device).manual_seed(1)
    for init in (True, False):
        ms = cuda_ms(lambda: km.assign_root(tr.kms, tr.state.ins_feat, tr.state.means,
                                            tr.state.alive, o.pos_weight, gen, init=init),
                     iters=3)
        log(f"timing: assign_root, k1 = {o.root_node_num}, {tr.state.capacity} slots, "
            f"{'fresh k-means++ seeds' if init else 'fresh seeds against the cached centers'}"
            f": {ms:.3f} ms [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from opengaussian_tpu_torch.cli import render as cli_render
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.models.loading import load_model
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render
    from opengaussian_tpu_torch.train.loop import bundle_views

    # 1. device
    card = smi()
    log(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bytes = next((f, b) for key, f, b in PEAKS if key in name)

    # 2. build
    t0 = time.perf_counter()
    libs, build_log = rk.build()
    log(f"build: {', '.join(sorted(libs))} in {time.perf_counter() - t0:.3f} s")
    for line in build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        model, scene_dir = write_model_and_scene(root)
        state, _, _ = load_model(model, device=dev)
        scene = load_scene(scene_dir, eval_split=True)
        views = scene.train_views + scene.test_views
        log(f"setup: {N_SPLATS} splats (capacity {state.capacity}), "
            f"{len(views)} views {WIDTH}x{HEIGHT} in {time.perf_counter() - t0:.1f} s")

        # 3. kernels against their plain versions, at the frame's own streams
        chunk = RasterizeConfig().chunk
        with torch.no_grad():
            streams = frame_streams(views[0].camera, state)
            k1_err, work = check_kernel_against_plain(streams, chunk)
        cam0 = views[0].camera.to(dev)
        grids = (streams[4][4], (HEIGHT + 15) // 16)
        gt0 = torch.as_tensor(views[0].gt_image, device=dev)
        cot = loss_cotangents(cam0, grids, streams[4], chunk, gt0)
        grad = check_grad_kernels(streams[4], cot, chunk, state.capacity)
        # the dense layout on the same frame's feature pass, K fitted to it
        # as the trainer fits max_per_tile
        k_dense = fitted_max_per_tile(int(streams[7][5].deepest), chunk)
        sam = bundle_views(views[:1], OptimizationConfig().sam_level, dev)
        with torch.no_grad():
            block = frame_dense(views[0].camera, state, k_dense)
        gdata = block[0]
        log(f"dense block: [T, K, F] = {list(gdata.shape)} ({gdata.numel() * 4 / 1e9:.3f} "
            f"GB), {int(block[1].sum())} live rows, n_truncated {block[4]}")
        if block[4] != 0:
            raise AssertionError("the fitted max_per_tile truncated a tile")
        dense = check_dense_kernels(block, cam0, grids, sam.sam_ids[0], sam.max_masks,
                                    chunk, state.capacity)
        check_against_oracle(dev)
        check_step_against_cpu(dev)
        check_feature_steps_against_cpu(dev)

        # 4. render path, through the CLI a user runs
        for w in launch_counts().values():
            w.launches = 0
        t0 = time.perf_counter()
        n_views = cli_render.main(["-m", model, "-s", scene_dir], device=dev)
        torch.cuda.synchronize()
        render_launches = {k: w.launches for k, w in launch_counts().items()}
        log(f"render path: {n_views} views in {time.perf_counter() - t0:.2f} s, "
            f"launches {render_launches}")
        if n_views != N_VIEWS or render_launches["blend_stream_fwd"] != 2 * n_views:
            raise AssertionError(f"expected 2 x {N_VIEWS} launches, got "
                                 f"{render_launches} for {n_views} views")
        for split, nv in (("train", len(scene.train_views)), ("test", len(scene.test_views))):
            for sub in ("renders", "gt", "ins_feat1", "ins_feat2", "sam_mask"):
                d = os.path.join(model, split, "ours", sub)
                if sorted(os.listdir(d)) != [f"{i:05d}.png" for i in range(nv)]:
                    raise AssertionError(f"missing PNGs in {d}")
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            for i, v in enumerate(views):
                for C, (*_s, bins, _p) in frame_streams(v.camera, state).items():
                    log(f"view {i} C={C}: slots={int(bins.counts.sum())} "
                        f"n_dropped={int(bins.n_dropped)} "
                        f"n_truncated={int(bins.n_truncated)} "
                        f"deepest_tile={int(bins.deepest)}")
                    if int(bins.n_dropped) != 0:
                        raise AssertionError("n_dropped must be 0")
                out = render(v.camera, state, bg, 3, RasterizeConfig(), render_color=True,
                             render_feat_map=True, origin_feat=True)
                for k in ("render", "alpha", "depth", "ins_feat", "silhouette"):
                    x = getattr(out, k)
                    if not bool(torch.isfinite(x).all()):
                        raise AssertionError(f"view {i}: {k} is not finite")
                if out.render.shape != (HEIGHT, WIDTH, 3) or \
                        out.ins_feat.shape != (HEIGHT, WIDTH, 6):
                    raise AssertionError("render shapes")
                if not 0.05 < float(out.alpha.mean()) <= 1.0:
                    raise AssertionError(f"view {i}: empty frame")
            # the two input layouts render the same view alike
            layouts = {lay: render(views[0].camera, state, bg, 3,
                                   RasterizeConfig(max_per_tile=k_dense, pallas_input=lay),
                                   render_color=True, render_feat_map=True, origin_feat=True)
                       for lay in ("stream", "dense")}
            dense_render_err = 0.0
            for k in ("render", "alpha", "depth", "ins_feat", "silhouette"):
                dense_render_err = max(dense_render_err, compare(
                    f"render {k}, dense against stream layout", getattr(layouts["dense"], k),
                    getattr(layouts["stream"], k), TOL["atol"], TOL["rtol"]))
            log(f"render, view 0: the dense layout's images equal the stream layout's, "
                f"max abs err {dense_render_err:.3e}")

        # 5. training path, through the CLI a user runs, in each input layout
        tr, train_launches, out = train_path(scene_dir, root, dev)
        check_trained_render(out, scene_dir, dev)
        tr_d, dense_launches, _ = train_path(scene_dir, root, dev,
                                             RasterizeConfig(pallas_input="dense"))
        l_s, l_d = float(tr.losses[0]), float(tr_d.losses[0])
        if not math.isclose(l_d, l_s, rel_tol=1e-5):
            raise AssertionError(f"first loss: dense layout {l_d!r}, stream {l_s!r}")
        log(f"training path: first loss {l_d:.7f} (dense) and {l_s:.7f} (stream)")
        del tr_d

        # 6. timings
        k_ms, p_ms = {}, {}
        with torch.no_grad():
            flush = torch.empty(2**26, dtype=torch.float32, device=dev)  # 256 MB > L2
            f_ms = cuda_ms(flush.zero_, iters=10)
            for C, (rows, counts, tstart, toff, gx, *_r) in streams.items():
                k1 = lambda: rk.blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)  # noqa: E731
                k_ms[C] = cuda_ms(k1, iters=20, warmup=3)
                cold = cuda_ms(lambda: (flush.zero_(), k1()), iters=10) - f_ms
                p_ms[C] = cuda_ms(lambda: rk.blend_stream_fwd_plain(
                    rows, counts, tstart, toff, gx, chunk), iters=2)
                log(f"timing: blend_stream_fwd C={C}: kernel {k_ms[C]:.4f} ms/launch "
                    f"({cold:.4f} with L2 flushed), plain {p_ms[C]:.3f} ms/launch, "
                    f"evaluated pairs {work[C]['evaluated']} [{card}]")
            rows, counts, tstart, toff, gx, bins, _ = streams[4]
            bargs = (rows, counts, tstart, toff, *cot, gx, chunk)
            k2_ms = cuda_ms(lambda: rk.blend_stream_bwd(*bargs), iters=20, warmup=3)
            k2_cold = cuda_ms(lambda: (flush.zero_(), rk.blend_stream_bwd(*bargs)),
                              iters=10) - f_ms
            k2_plain = cuda_ms(lambda: rk.blend_stream_bwd_plain(*bargs), iters=2)
            log(f"timing: blend_stream_bwd C=4: kernel {k2_ms:.4f} ms/launch "
                f"({k2_cold:.4f} with L2 flushed), plain {k2_plain:.3f} ms/launch, "
                f"composited pairs {grad['work']['blended']} [{card}]")
            d_rows, ids, n = grad["d_rows"], bins.sorted_gauss, state.capacity
            k3_ms = cuda_ms(lambda: rk.segment_reduce(d_rows, ids, n), iters=20, warmup=3)
            k3_plain = cuda_ms(lambda: rk.segment_reduce_plain(d_rows, ids, n), iters=5)
            ids64 = ids.to(torch.int64)
            lib_ms = cuda_ms(lambda: torch.zeros((n, d_rows.shape[1]), device=dev)
                             .index_add_(0, ids64, d_rows), iters=20, warmup=3)
            log(f"timing: segment_reduce: kernel {k3_ms:.4f} ms/launch, plain "
                f"{k3_plain:.4f} ms, library (zeros + index_add_) {lib_ms:.4f} ms, "
                f"{d_rows.shape[0]} rows x {d_rows.shape[1]} fields into {n} splats "
                f"[{card}]")
            # K5 and K6 on the dense block of phase 3
            gdata, dcounts, gauss_idx, gx, _ = block
            T, K, F = gdata.shape
            k5 = lambda: rk.blend_tiles_fwd(gdata, dcounts, gx, chunk)  # noqa: E731
            k5_ms = cuda_ms(k5, iters=20, warmup=3)
            k5_cold = cuda_ms(lambda: (flush.zero_(), k5()), iters=10) - f_ms
            acc5, tf5 = k5()
            k5_plain = cuda_ms(lambda: rk.blend_tiles_fwd_plain(gdata, dcounts, gx, chunk),
                               iters=2)
            log(f"timing: blend_tiles_fwd C={F - 6}: kernel {k5_ms:.4f} ms/launch "
                f"({k5_cold:.4f} with L2 flushed), plain {k5_plain:.3f} ms/launch, "
                f"evaluated pairs {dense['work_fwd']['evaluated']} [{card}]")
            b6 = (gdata, dcounts, acc5, tf5, *dense["cot"], gx, chunk)
            k6_ms = cuda_ms(lambda: rk.blend_tiles_bwd(*b6), iters=20, warmup=3)
            k6_cold = cuda_ms(lambda: (flush.zero_(), rk.blend_tiles_bwd(*b6)),
                              iters=10) - f_ms
            k6_plain = cuda_ms(lambda: rk.blend_tiles_bwd_plain(*b6), iters=2)
            fill_ms = cuda_ms(lambda: torch.zeros_like(gdata), iters=20, warmup=3)
            log(f"timing: blend_tiles_bwd C={F - 6}: kernel {k6_ms:.4f} ms/launch "
                f"({k6_cold:.4f} with L2 flushed; the d_slot zero fill of "
                f"{gdata.numel() * 4 / 1e9:.3f} GB before it takes {fill_ms:.4f} ms), "
                f"plain {k6_plain:.3f} ms/launch, composited pairs "
                f"{dense['work_bwd']['blended']} [{card}]")
            full = torch.empty((T, tr.rcfg.max_per_tile, F), device=dev)
            big_fill = cuda_ms(full.zero_, iters=10, warmup=2)
            log(f"timing: the zero fill of a [T, K, F] = {list(full.shape)} block "
                f"({full.numel() * 4 / 1e9:.3f} GB, the trained frame's feature pass at "
                f"its fitted max_per_tile): {big_fill:.4f} ms [{card}]")
            del full
            rows6 = torch.zeros((T * K, F), device=dev)
            k3d_ms = cuda_ms(lambda: rk.segment_reduce(rows6, dense["ids"], n), iters=10)
            log(f"timing: segment_reduce over the dense block's {T * K} rows (dead ones "
                f"dropped by id): {k3d_ms:.4f} ms [{card}]")
            render_all = lambda: [render(v.camera, state, bg, 3, RasterizeConfig(),  # noqa: E731
                                         render_color=True, render_feat_map=True,
                                         origin_feat=True) for v in views]
            r_ms = cuda_ms(render_all, iters=3) / len(views)
            log(f"timing: render {r_ms:.3f} ms/view (color + feature pass) [{card}]")
            log("timing: library_ms null for K1, K2, K5 and K6: no single PyTorch call "
                "computes a depth-ordered alpha blend with early stop, or its replay")
            busy, wall = profile(lambda: render(views[0].camera, state, bg, 3,
                                                RasterizeConfig(), render_color=True,
                                                render_feat_map=True, origin_feat=True),
                                 len(views), "render")
            log(f"timing: device idle share during the profiled render "
                f"{1.0 - busy / wall:.3f} (busy {busy:.3f} of {wall:.3f} ms/view, "
                f"both from that run) [{card}]")
        time_feature_stages(tr, card)
        time_step(tr, card)
        k1_bound = {C: fwd_bound(f"blend_stream_fwd C={C}", int(counts.sum()), rows.shape[1],
                                 counts.shape[0], 3, work[C], peak_flops, peak_bytes)
                    for C, (rows, counts, *_r) in streams.items()}
        for C, (b, by) in k1_bound.items():
            log(f"bound: blend_stream_fwd C={C}: {b:.4f} ms/launch ({by}), "
                f"kernel at {b / k_ms[C]:.3f} of it [{card}]")
        rows, counts = streams[4][:2]
        k2_b, k2_by = bwd_bound("blend_stream_bwd C=4", int(counts.sum()), rows.shape[1],
                                counts.shape[0], 3, grad["work"], peak_flops, peak_bytes)
        log(f"bound: blend_stream_bwd C=4: {k2_b:.4f} ms/launch ({k2_by}), kernel at "
            f"{k2_b / k2_ms:.3f} of it [{card}]")
        k3_b, k3_by = reduce_bound(d_rows, n, peak_flops, peak_bytes)
        log(f"bound: segment_reduce: {k3_b:.4f} ms/launch ({k3_by}), kernel at "
            f"{k3_b / k3_ms:.3f} of it [{card}]")
        live = int(dcounts.sum())
        k5_b, k5_by = fwd_bound(f"blend_tiles_fwd C={F - 6}", live, F, T, 1,
                                dense["work_fwd"], peak_flops, peak_bytes)
        log(f"bound: blend_tiles_fwd C={F - 6}: {k5_b:.4f} ms/launch ({k5_by}), kernel at "
            f"{k5_b / k5_ms:.3f} of it [{card}]")
        k6_b, k6_by = bwd_bound(f"blend_tiles_bwd C={F - 6}", live, F, T, 1,
                                dense["work_bwd"], peak_flops, peak_bytes)
        log(f"bound: blend_tiles_bwd C={F - 6}: {k6_b:.4f} ms/launch ({k6_by}), kernel at "
            f"{k6_b / k6_ms:.3f} of it [{card}]")

    k1_b = [b for b, _ in k1_bound.values()]

    def row(name, launches, err, ms, plain, bound, by, lib=None, line=None):
        return {"name": name, "route": "cuda",
                "source": f"opengaussian_tpu_torch/csrc/{name}.cu",
                "replaces": f"opengaussian_tpu/ops/rasterize_pallas.py:{line}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": lib}

    main_paths = (render_launches, train_launches, dense_launches)
    total = {k: sum(p[k] for p in main_paths) for k in render_launches}
    log(f"launches on the main paths: render {render_launches}, training (stream) "
        f"{train_launches}, training (dense) {dense_launches}")
    kernels = [
        row("blend_stream_fwd", total["blend_stream_fwd"], k1_err,
            sum(k_ms.values()) / len(k_ms), sum(p_ms.values()) / len(p_ms),
            sum(k1_b) / len(k1_b), max(k1_bound.values())[1], line=562),
        row("blend_stream_bwd", total["blend_stream_bwd"], grad["k2_err"], k2_ms, k2_plain,
            k2_b, k2_by, line=670),
        row("segment_reduce", total["segment_reduce"], max(grad["k3_err"], dense["k3_err"]),
            k3_ms, k3_plain, k3_b, k3_by, lib=lib_ms, line=1196),
        row("blend_tiles_fwd", total["blend_tiles_fwd"], dense["k5_err"], k5_ms, k5_plain,
            k5_b, k5_by, line=322),
        row("blend_tiles_bwd", total["blend_tiles_bwd"], dense["k6_err"], k6_ms, k6_plain,
            k6_b, k6_by, line=413),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
