"""Drive the PyTorch port (opengaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA kernel of the port (one nvcc per csrc/*.cu, all
     started together), from the sources in the checkout.
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the streams of a full-width frame (1296x968, 200k splats, SH degree 3,
     6-D instance features): the forward blend K1 at C = 4 (RGB + depth) and
     C = 7 (features + depth); the backward replay K2, the compact backward
     K4 and the per-splat reduce K3 on the C = 4 stream, with the cotangents
     of an L1 + SSIM loss against the view's image, K4 again on the same
     stream made of flat opaque splats (every tile stops after one chunk),
     and K4 + K3 against K2 + K3 per splat. The dense layout's forward K5, its backward K6 and
     K3 over its rows on the same frame's C = 7 dense block, with the
     cotangents of the stage-1 loss (separation + cohesion on the view's SAM
     masks). A partition render of one root's 5 leaves against the same
     leaves rendered one by one. Then the rasterizer on the card against the
     naive oracle on the CPU, and at 160x120 one stage-0 step, one stage-1
     and one stage-2.1 step in each input layout, one stage-2.2 step in the
     stream, dense and compact configurations, one sweep-2 view, one stage-3
     view and assign_leaf, on the card against the same on the CPU.
  4. render path: `opengaussian_tpu_torch.cli.render.main` renders a
     synthetic trained model (written as a PLY) of a 3-view COLMAP scene;
     checks the outputs and that K1 ran on this path. One view rendered
     with pallas_input="dense" equals the stream render.
  5. training path: `opengaussian_tpu_torch.cli.train.main` trains 80
     iterations on the same 3-view scene, whose points3D.bin holds the 200k
     points and whose sidecars hold 16 level-3 SAM masks and a CLIP table
     per view: 40 stage-0 steps with densify events after steps 20, 30 and
     40 (the first grows the capacity) and an opacity reset after step 30, 10
     stage-1 steps, sweep 1 and the root k-means (k1 = 64) at 51, 10
     stage-2.1 steps, sweeps 1 and 2 and the leaf k-means of root 0 at 61,
     20 stage-2.2 steps over roots 0-4 (the next every 5 iterations), then
     stage 3 over every root and view, and a checkpoint at 80. Checks the
     launches each kernel must make on that schedule, that every loss is
     finite and the stage-0 loss falls, that the geometry is bit for bit the
     same in the PLYs saved at iterations 40 and 80 while ins_feat moved,
     the root and leaf codebooks and cluster_lang.npz, that the checkpoint
     reloads bit for bit, and that `cli.render` renders the saved PLY. The
     same schedule runs with RasterizeConfig(pallas_input="dense") (K5, K6,
     K3) and with bwd_layout="compact" (K1, K4, K3); their first losses
     equal the stream run's.
  6. timings (CUDA events after warm-up), each line with the card's name:
     each kernel against its plain version and its bound, K3's index_add_
     yardstick, K2 + K3 against K4 + K3, the dense block's zero fill, the
     render, the stage-0 step and its phases, the stage-1 and stage-2.1
     steps in both layouts, the stage-2.2 step of each training run, sweeps
     1 and 2 and stage 3 per view, the root and leaf k-means, and
     torch.profiler's device time by kernel over one render of each view and
     over one step of each stage, which give the card's idle share in each.
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
TRAIN_ITERS = 80
# the iteration each stage ends at: 0 (3DGS), 1 (SAM features), 2.1 (roots);
# stage 2.2 (leaves) runs to TRAIN_ITERS, then stage 3
STAGE_ENDS = dict(start_ins_feat_iter=40, start_root_cb_iter=50, start_leaf_cb_iter=60)
LEAF_UPDATE_FR = 5  # stage 2.2 moves to the next root every 5 iterations
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
        # the CLIP table of the level-3 masks (ids 1-15 after the level offset)
        np.save(os.path.join(scene, "language_features", f"view_{i:03d}_f.npy"),
                rng.normal(0, 1, (16, 512)).astype(np.float32))
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
    g_accum, g_t = torch.autograd.grad(rgb_loss(image[0], gt), (a, t))
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
    feat, sil, _ = (x[0] for x in _images(camera, grids, a, t,
                                          torch.zeros(6, device=a.device)))
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


def poison_allocator(rows: int, F: int, dev) -> None:
    """Leave NaN-filled blocks the size of K4's two outputs in PyTorch's
    caching allocator, which the wrapper's torch.empty then reuses: a row
    or an id the kernel fails to write shows as NaN or as a wrong id."""
    blocks = [torch.full((rows, F), float("nan"), device=dev),
              torch.full((rows,), float("nan"), device=dev)]
    del blocks


def check_compact_kernel(stream, cot, chunk: int, n: int, d_rows_k2) -> dict:
    """blend_stream_bwd_compact (K4) against its plain version on the card,
    bit for bit, on one frame's stream and loss cotangents, and on the same
    stream with near-opaque splats, where the tiles stop early and K4 must
    zero the live rows past the stop itself; then K4 + K3 against K2 + K3
    per splat. -> {"k4_err", "k43_err", "d", "ids"}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    rows, counts, tstart, toff, gx, bins, _ = stream
    nc_rows = rk.compact_offsets(counts, chunk)[1] * chunk
    args = (rows, counts, tstart, toff, bins.sorted_gauss, *cot, gx, chunk, n)
    poison_allocator(nc_rows, rows.shape[1], rows.device)
    d, ids = rk.blend_stream_bwd_compact(*args)
    torch.cuda.synchronize()
    d_p, ids_p = rk.blend_stream_bwd_compact_plain(*args)
    k4 = compare("blend_stream_bwd_compact C=4 d_rows", d, d_p, 0.0, 0.0)
    if not torch.equal(ids, ids_p):
        raise AssertionError("K4: the ids differ from the plain version's")
    # flat splats (conic 0) of opacity 0.98 cover every pixel of their tile
    # at alpha 0.98, so every pixel stops at its third slot and every tile's
    # walk at the end of its first chunk
    flat = rows.clone()
    flat[:, 2:5] = 0.0
    flat[:, 5] = 0.98
    acc_o, t_o = rk.blend_stream_fwd(flat, counts, tstart, toff, gx, chunk)
    args_o = (flat, counts, tstart, toff, bins.sorted_gauss, acc_o, t_o, *cot[2:], gx,
              chunk, n)
    poison_allocator(nc_rows, rows.shape[1], rows.device)
    d_o, ids_o = rk.blend_stream_bwd_compact(*args_o)
    torch.cuda.synchronize()
    d_op, ids_op = rk.blend_stream_bwd_compact_plain(*args_o)
    k4 = max(k4, compare("blend_stream_bwd_compact C=4 d_rows, flat opaque splats", d_o,
                         d_op, 0.0, 0.0))
    if not torch.equal(ids_o, ids_op):
        raise AssertionError("K4, flat opaque splats: the ids differ from the plain "
                             "version's")
    past = int(torch.clamp(counts - chunk, min=0).sum())
    log(f"K4, flat opaque splats: every tile stops after its first chunk, {past} of "
        f"{int(counts.sum())} live rows past the stop, zero-written by K4")
    if past == 0:
        raise AssertionError("K4: no tile of the frame is deeper than one chunk")
    per4 = rk.segment_reduce(d, ids, n)
    per2 = rk.segment_reduce(d_rows_k2, bins.sorted_gauss, n)
    torch.cuda.synchronize()
    k43 = compare("K4 + K3 against K2 + K3 per splat", per4, per2, grad_atol(per2),
                  GRAD_TOL["rtol"])
    log(f"K4: {d.shape[0]} compacted rows for {int(counts.sum())} live slots, "
        f"{int((ids == n).sum())} tail rows with id n")
    return dict(k4_err=k4, k43_err=k43, d=d, ids=ids)


def check_partition_against_scan(camera, state, dev) -> float:
    """At full width, one root's 5 leaves (splats given seeded roots of 64
    and leaves of 5) rendered in one partition pass (rasterize_partition)
    and one by one (rasterize_scan_groups): images and silhouettes within
    TOL, the same occur and valid flags. -> the largest error."""
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render_clusters, render_clusters_partition

    rng = np.random.default_rng(21)
    cap = state.capacity
    leaf = torch.as_tensor(rng.integers(0, 64, cap) * 5 + rng.integers(0, 5, cap),
                           dtype=torch.int32, device=dev)
    groups = torch.arange(5, device=dev)  # root 0's leaves
    kw = dict(origin_feat=True, min_points=10)
    with torch.no_grad():
        part = render_clusters_partition(camera, state, torch.zeros(3, device=dev), leaf,
                                         groups, RasterizeConfig(), **kw)
        scan = render_clusters(camera, state, torch.zeros(3, device=dev), leaf, groups,
                               RasterizeConfig(), **kw)
    err = max(compare(f"partition against scan, {k}", getattr(part, k), getattr(scan, k),
                      TOL["atol"], TOL["rtol"])
              for k in ("cluster_imgs", "cluster_silhouettes"))
    for k in ("cluster_occur", "cluster_valid"):
        if not torch.equal(getattr(part, k), getattr(scan, k)):
            raise AssertionError(f"partition against scan: {k} differ")
    log(f"partition render of root 0's 5 leaves ({int((leaf < 5).sum())} splats) equals "
        f"the scan render, max abs err {err:.3e}; valid {part.cluster_valid.tolist()}")
    return err


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


def blob_scene(W: int, H: int, n: int = 600, cap: int = 1024):
    """Two opaque blobs of n / 2 splats, each one root cluster, under two
    SAM masks that their rendered silhouette aligns (left, right), so sweep
    2 and stage 3 match them. -> (state on the CPU, root ids [cap] int32,
    camera, SAM ids [H, W] int32)."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render

    rng = np.random.default_rng(13)
    h = n // 2
    pts = np.concatenate([rng.normal(0, 0.08, (h, 3)) + [-0.5, 0, 3.0],
                          rng.normal(0, 0.08, (h, 3)) + [0.5, 0, 3.0]]).astype(np.float32)
    st = G.create_from_pcd(pts, rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
                           capacity=cap, device="cpu")
    feat = np.zeros((cap, 6), np.float32)
    feat[:h] = [0.9, -0.9, 0.9, -0.9, 0.9, -0.9]
    feat[h:n] = [-0.9, 0.9, -0.9, 0.9, -0.9, 0.9]
    feat[:n] += rng.normal(0, 0.05, (n, 6))
    st = dataclasses.replace(
        st, log_scales=torch.full_like(st.log_scales, math.log(0.05)),
        logit_opacity=torch.where(st.alive, 4.0, -10.0), ins_feat=torch.as_tensor(feat))
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, W, H)
    with torch.no_grad():
        sil = render(cam, st, torch.zeros(3), 3, RasterizeConfig(), render_color=False,
                     render_feat_map=True, origin_feat=True).silhouette.numpy()
    sam = np.where(np.arange(W)[None, :] < W // 2, 1, 2)
    roots = np.zeros(cap, np.int32)
    roots[h:n] = 1
    return st, torch.as_tensor(roots), cam, np.where(sil > 0.5, sam, 0).astype(np.int32)


def normalised_err(got, want) -> float:
    return float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def check_stage22_against_cpu(dev):
    """At 160x120, on the card against the CPU: assign_leaf of both roots
    from the same seeds, one sweep-2 view, one stage-2.2 step in the stream,
    dense and compact configurations (each through its own kernels), and
    one stage-3 view (_associate_view, a partition render per root)."""
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.train import lang, loop
    from opengaussian_tpu_torch.train import pseudo as pseudo_mod

    W, H, k1, k2 = 160, 120, 2, 3
    base, roots, cam, sam = blob_scene(W, H)
    cfgs = {"stream": RasterizeConfig(), "dense": RasterizeConfig(pallas_input="dense"),
            "compact": RasterizeConfig(bwd_layout="compact")}
    kernels = {"stream": (rk.blend_stream_fwd, rk.blend_stream_bwd),
               "dense": (rk.blend_tiles_fwd, rk.blend_tiles_bwd),
               "compact": (rk.blend_stream_fwd, rk.blend_stream_bwd_compact)}
    res = []
    for on_card, d in ((False, torch.device("cpu")), (True, dev)):
        st = to_device(base, d)
        sam_d = torch.as_tensor(sam, device=d)
        kms = dataclasses.replace(km.KMeansState.create(st.capacity, k1, k2, d),
                                  cls_ids=roots.to(d))
        pl = pseudo_mod.construct_pseudo_labels(st, [cam], sam_d[None], torch.zeros(3, device=d),
                                                8, cfgs["stream"])
        s2 = pseudo_mod._sweep2_view(st, cam, pl.feat[0], pl.mask_ids[0], kms.cls_ids,
                                     torch.zeros(3, device=d), 8, k1, cfgs["stream"])
        kms = dataclasses.replace(kms, leaf_sub_num=torch.clamp(
            torch.maximum(torch.ones_like(s2[0]), s2[0]) + 1, max=k2))
        for r in range(k1):
            member = ((roots == r) & base.alive).to(d)
            kms = km.assign_leaf(kms, st.ins_feat, st.alive, r, k2, init=True,
                                 init_centers=st.ins_feat[member][:k2])
        t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
        bundle = loop.ViewBundle(
            R=t(cam.R_w2c)[None], t=t(cam.t_w2c)[None], fx=t(cam.fx)[None],
            fy=t(cam.fy)[None], cx=t(cam.cx)[None], cy=t(cam.cy)[None],
            gt_images=torch.zeros((1, H, W, 3), device=d),
            alpha_masks=torch.ones((1, H, W), device=d),
            has_alpha=torch.zeros(1, dtype=torch.bool, device=d), sam_ids=sam_d[None],
            width=W, height=H, max_masks=8)
        steps = {}
        for name, rcfg in cfgs.items():
            fwd, bwd = kernels[name]
            before = (fwd.launches, bwd.launches)
            steps[name] = loop.stage22_step(
                st, opt_mod.init(st.params()), kms, bundle, 0,
                STAGE_ENDS["start_leaf_cb_iter"] + 1, torch.zeros(3, device=d), 0.8,
                pl.feat[0], 1, True, rcfg, OptimizationConfig())
            torch.cuda.synchronize()
            launched = (fwd.launches - before[0], bwd.launches - before[1])
            if on_card and launched != (1, 1):
                raise AssertionError(f"stage-2.2 step ({name}): launches of {fwd.__name__}, "
                                     f"{bwd.__name__} {launched}, expected (1, 1)")
        before = rk.blend_stream_fwd.launches
        view = lang._associate_view(st, kms.leaf_cls_ids, cam, pl.feat[0], pl.mask_ids[0],
                                    s2[1], torch.zeros(3, device=d), k1, k2, 8, cfgs["stream"])
        if on_card and rk.blend_stream_fwd.launches - before != k1:
            raise AssertionError("stage-3 view: expected one K1 launch per root")
        res.append((st, kms, s2, steps, view))
    (_, kc, s2c, stc, vc), (st_g, kg, s2g, stg, vg) = res
    e_leaf = normalised_err(kg.leaf_centers, kc.leaf_centers)
    agree = float((kg.leaf_cls_ids.cpu() == kc.leaf_cls_ids).float().mean())
    if e_leaf > 1e-4 or agree < 0.999:
        raise AssertionError(f"assign_leaf: centers {e_leaf:.2e}, ids agree {agree:.4f}")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(s2g, s2c)) or not bool(s2c[1].all()):
        raise AssertionError(f"sweep 2: card {s2g}, cpu {s2c} (both roots must match)")
    worst = 0.0
    for name in cfgs:
        (s_c, a_c, l_c, ok_c, _), (s_g, a_g, l_g, ok_g, lost) = stc[name], stg[name]
        if not (bool(ok_g) and bool(ok_c)) or int(lost) != 0 or not math.isclose(
                float(l_g), float(l_c), rel_tol=1e-4) or not float(l_c) > 0:
            raise AssertionError(f"stage-2.2 step ({name}): loss card {float(l_g)} cpu "
                                 f"{float(l_c)}, ok {bool(ok_g)}/{bool(ok_c)}, lost {int(lost)}")
        for what, got, want in (("ins_feat", s_g.ins_feat, s_c.ins_feat),
                                ("mu", a_g.mu["ins_feat"], a_c.mu["ins_feat"]),
                                ("nu", a_g.nu["ins_feat"], a_c.nu["ins_feat"])):
            e = normalised_err(got, want)
            worst = max(worst, e)
            if not bool(torch.isfinite(got).all()) or e > 1e-3:
                raise AssertionError(f"stage-2.2 step ({name}): {what} normalised error {e:.3e}")
        for k in ("means", "sh_dc", "sh_rest", "log_scales", "quats", "logit_opacity"):
            if not torch.equal(getattr(s_g, k), getattr(st_g, k)):
                raise AssertionError(f"stage-2.2 step ({name}): the step changed {k}")
    if not (torch.equal(vg[0].cpu(), vc[0]) and torch.equal(vg[2].cpu(), vc[2])) or \
            float((vg[1].cpu() - vc[1]).abs().max()) > 1e-4 or not bool(vc[2].any()):
        raise AssertionError(f"stage-3 view: card {vg}, cpu {vc}")
    log(f"stage 2.2 at {W}x{H}, {int(base.num_alive)} splats: assign_leaf centers agree to "
        f"{e_leaf:.2e} (ids {agree:.4f}); sweep 2 counts {s2c[0].tolist()}, occur "
        f"{s2c[1].tolist()}; steps (stream, dense, compact) loss "
        + ", ".join(f"{float(stg[k][2]):.6f}" for k in cfgs)
        + " (cpu " + ", ".join(f"{float(stc[k][2]):.6f}" for k in cfgs)
        + f"), ins_feat and moments to a normalised {worst:.2e}, geometry unchanged; "
        f"stage-3 view: {int(vc[2].sum())} of {k1 * k2} leaves matched on both")


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


def device_ms(fn, n: int, kernel: str) -> float:
    """Device time per call of the kernels whose name holds `kernel`, by
    torch.profiler over n calls: the kernel alone, without the host work of
    its wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not us:
        raise AssertionError(f"the profiler recorded no {kernel}")
    if len(us) != n:  # per kernel the profiler recorded, not per call
        log(f"profile: {len(us)} {kernel} launches recorded of {n} calls")
    return sum(us) / 1e3 / len(us)


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
                                        "blend_stream_bwd_compact", "segment_reduce",
                                        "blend_tiles_fwd", "blend_tiles_bwd")}


def expected_launches(tr, rcfg) -> dict:
    """Each kernel's launches on the training path, from the schedule: one
    forward and one backward per step; sweep 1 (one render per view) at the
    entries to stages 2.1 and 2.2; sweep 2 at stage-2.2 entry, one render per
    root and view; stage 3, per view one partition render per root (stream)
    or one render per leaf (dense)."""
    o, V = tr.cfg.opt, tr.bundle.num_views
    k1, k2 = o.root_node_num, o.leaf_node_num
    dense = rcfg.pallas_input == "dense"
    fwd = "blend_tiles_fwd" if dense else "blend_stream_fwd"
    bwd = ("blend_tiles_bwd" if dense else
           "blend_stream_bwd_compact" if rcfg.bwd_layout == "compact" else "blend_stream_bwd")
    want = dict.fromkeys(launch_counts(), 0)
    want[fwd] = TRAIN_ITERS + 2 * V + k1 * V + (k1 * k2 if dense else k1) * V
    want[bwd] = want["segment_reduce"] = TRAIN_ITERS
    return want


def train_path(scene_dir: str, root: str, dev, name: str, rcfg) -> tuple:
    """The training main path: cli.train.main for TRAIN_ITERS iterations
    through stages 0, 1, 2.1 and 2.2, then stage 3 (rcfg: the rasterizer's
    settings), every kernel's launches counted around it. Checks the
    launches, the losses, the geometry across the feature stages, the
    codebooks, cluster_lang.npz and the checkpoint.
    -> (trainer, {kernel: launches}, output dir, seconds)."""
    from opengaussian_tpu_torch.cli import train as cli_train
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply
    from opengaussian_tpu_torch.train import checkpoint
    from opengaussian_tpu_torch.utils.codebook import load_codebook

    out = os.path.join(root, f"trained_{name}")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    flags = [x for k, v in STAGE_ENDS.items() for x in (f"--{k}", str(v))]
    tr = cli_train.main(
        ["-s", scene_dir, "-m", out, "--iterations", str(TRAIN_ITERS), *flags,
         "--densify_from_iter", "10", "--densification_interval", "10",
         "--opacity_reset_interval", "30", "--leaf_update_fr", str(LEAF_UPDATE_FR),
         "--checkpoint_iterations", str(TRAIN_ITERS)], device=dev, rcfg=rcfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    what = f"training path ({name})"
    log(f"{what}: {TRAIN_ITERS} iterations and stage 3 in {seconds:.2f} s (scene load, "
        f"setup, sweeps, stage 3, saves and the checkpoint included), launches {launches}")
    want = expected_launches(tr, rcfg)
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
    o = tr.cfg.opt
    log(f"{what}: mean loss of steps 1-10, ..., {TRAIN_ITERS - 9}-{TRAIN_ITERS}: "
        + ", ".join(f"{x:.5f}" for x in m)
        + f"; capacity {tr.state.capacity}, alive {int(tr.state.num_alive)}, "
        f"max_per_tile {tr.rcfg.max_per_tile}, slots lost in the last step "
        f"{int(tr._last_lost)}, last root {tr.root_id}, leaf_sub_num "
        f"{tr.kms.leaf_sub_num.tolist()}, roots occurring per view "
        f"{tr.pseudo.cluster_occur.sum(dim=1).tolist()}")
    if tr.state.capacity <= N_SPLATS + 4096:
        raise AssertionError(f"{what}: the capacity did not grow")
    if tr.root_id != (TRAIN_ITERS - STAGE_ENDS["start_leaf_cb_iter"]) // LEAF_UPDATE_FR:
        raise AssertionError(f"{what}: stage 2.2 ended at root {tr.root_id}")
    # past stage 0 only ins_feat learns: the PLYs of iterations 40 and 80
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
    n_alive = int(tr.state.num_alive)
    last = os.path.join(pc, f"iteration_{TRAIN_ITERS}")
    for book, shape in (("root_code_book", (o.root_node_num, 9)),
                        ("leaf_code_book", (o.root_node_num * o.leaf_node_num + 1, 6))):
        centers, ids = load_codebook(os.path.join(last, book))
        if centers.shape != shape or len(ids) != n_alive:
            raise AssertionError(f"{what}: {book} {centers.shape}, {len(ids)} ids for "
                                 f"{n_alive} splats")
    z = np.load(os.path.join(out, "cluster_lang.npz"))
    k = o.root_node_num * o.leaf_node_num
    if z["leaf_feat"].shape != (k, 512) or z["leaf_score"].shape != (k,) or \
            z["occu_count"].shape != (k,) or len(z["leaf_ind"]) != n_alive or \
            not all(np.isfinite(z[f]).all() for f in z.files):
        raise AssertionError(f"{what}: cluster_lang.npz " + str({f: z[f].shape for f in z.files}))
    # the checkpoint of the last iteration reloads bit for bit
    st, adam, stats, kms, it = checkpoint.load(os.path.join(out, f"chkpnt{TRAIN_ITERS}.npz"), dev)
    pairs = ([(f"state {f.name}", getattr(st, f.name), getattr(tr.state, f.name))
              for f in dataclasses.fields(st)]
             + [(f"kmeans {f.name}", getattr(kms, f.name), getattr(tr.kms, f.name))
                for f in dataclasses.fields(kms)]
             + [(f"stats {f.name}", getattr(stats, f.name), getattr(tr.stats, f.name))
                for f in dataclasses.fields(stats)]
             + [(f"adam {k}", adam.mu[k], tr.adam.mu[k]) for k in adam.mu]
             + [(f"adam {k}", adam.nu[k], tr.adam.nu[k]) for k in adam.nu])
    bad = [nm for nm, x, y in pairs if not torch.equal(x, y)]
    if it != TRAIN_ITERS or adam.count != tr.adam.count or bad:
        raise AssertionError(f"{what}: the checkpoint does not reload bit for bit: {bad}")
    log(f"{what}: geometry bit for bit equal at iterations "
        f"{STAGE_ENDS['start_ins_feat_iter']} and {TRAIN_ITERS} ({len(a['means'])} "
        f"splats), ins_feat moved up to {moved:.4f}; root and leaf codebooks with one id "
        f"per alive splat; cluster_lang.npz: {int((z['occu_count'] > 0).sum())} of {k} "
        f"leaves matched in some view (the synthetic scene need not clear stage 3's "
        f"gates); chkpnt{TRAIN_ITERS}.npz reloads bit for bit")
    return tr, launches, out, seconds


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


def time_stage22(tr, card: str, name: str, profiled: bool = False, rcfg=None) -> float:
    """The stage-2.2 step of a trained run (10 steps between two CUDA
    events, each from the same state, over roots 0-4 and the views) with
    the run's rasterizer settings or rcfg; with profiled, torch.profiler
    over one step gives the idle share. -> ms per step."""
    from opengaussian_tpu_torch.train import loop

    o, V = tr.cfg.opt, tr.bundle.num_views
    rcfg = rcfg or tr.rcfg

    def step(i):
        loop.stage22_step(tr.state, tr.adam, tr.kms, tr.bundle, i % V,
                          o.start_leaf_cb_iter + 1, tr.bg, 1.0, tr.pseudo.feat[i % V], i % 5,
                          tr.pseudo.cluster_occur[i % V, i % 5], rcfg, o, tr.any_alpha)

    i = iter(range(1000))
    ms = cuda_ms(lambda: step(next(i)), iters=10)
    log(f"timing: stage-2.2 step, {name} run: {ms:.3f} ms (capacity {tr.state.capacity}, "
        f"{int(tr.state.num_alive)} alive, max_per_tile {tr.rcfg.max_per_tile}, roots 0-4) "
        f"[{card}]")
    if profiled:
        busy, wall = profile(lambda: step(0), 1, f"stage-2.2 step ({name})")
        log(f"timing: device idle share during the profiled stage-2.2 step ({name}) "
            f"{1.0 - busy / wall:.3f} (busy {busy:.3f} of {wall:.3f} ms) [{card}]")
    return ms


def time_leaf_events(tr, card: str, name: str) -> dict:
    """Sweep 2 and stage 3 per view, and, once, assign_leaf per call (fresh
    seeds, and from the cached centers)."""
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.train import lang
    from opengaussian_tpu_torch.train import pseudo as pseudo_mod

    o, V, b = tr.cfg.opt, tr.bundle.num_views, tr.bundle
    k1, k2 = o.root_node_num, o.leaf_node_num
    i = iter(range(1000))
    s2 = cuda_ms(lambda: pseudo_mod._sweep2_view(
        tr.state, b.camera(next(i) % V), tr.pseudo.feat[0], tr.pseudo.mask_ids[0],
        tr.kms.cls_ids, tr.bg, b.max_masks, k1, tr.rcfg), iters=2)
    s3 = cuda_ms(lambda: lang._associate_view(
        tr.state, tr.kms.leaf_cls_ids, b.camera(next(i) % V), tr.pseudo.feat[0],
        tr.pseudo.mask_ids[0], tr.pseudo.cluster_occur[0], tr.bg, k1, k2, b.max_masks,
        tr.rcfg), iters=2)
    log(f"timing: sweep 2, {name} run: {s2:.3f} ms per view ({k1} single-root renders); "
        f"stage 3: {s3:.3f} ms per view ({k1} roots x {k2} leaves, "
        f"{'one render per leaf' if tr.rcfg.pallas_input == 'dense' else 'one partition render per root'}"
        f") [{card}]")
    out = dict(sweep2=s2, stage3=s3)
    if name == "stream":
        gen = torch.Generator(device=tr.device).manual_seed(1)
        for init in (True, False):
            ms = cuda_ms(lambda: km.assign_leaf(tr.kms, tr.state.ins_feat, tr.state.alive, 0,
                                                k2, gen, init=init), iters=5)
            log(f"timing: assign_leaf, root 0 of {k1}, k2 = {k2}, {tr.state.capacity} slots, "
                f"{'fresh k-means++ seeds' if init else 'from the cached centers'}: "
                f"{ms:.3f} ms [{card}]")
            out[f"assign_leaf_{init}"] = ms
    return out


def compact_bound(live: int, nc_rows: int, F: int, T: int, work, peak_flops,
                  peak_bytes) -> tuple[float, str]:
    """K4: the live rows and their splat ids read once, every owned row and
    its id written once (NC * chunk of each), the [T] counts, tstart, toff
    and cstart tables, accum/g_accum/t_final/g_t read once; the replay's
    operations from its pair counts, as K2's."""
    C = F - 6
    moved = (live * (F + 1) * 4 + nc_rows * (F + 1) * 4 + 4 * T * 4
             + 2 * T * 256 * (C + 1) * 4)
    ops = (work["evaluated"] * OPS_EVALUATED + work["tested"] * OPS_TESTED
           + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1))
    return bound_of("blend_stream_bwd_compact", moved, ops, peak_flops, peak_bytes)


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
        compact = check_compact_kernel(streams[4], cot, chunk, state.capacity, grad["d_rows"])
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
        partition_err = check_partition_against_scan(cam0, state, dev)
        check_stage22_against_cpu(dev)

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
        # and with the compact backward; each run's stage-2.2 step and leaf
        # events are timed from its own trained state
        runs = {"stream": RasterizeConfig(), "dense": RasterizeConfig(pallas_input="dense"),
                "compact": RasterizeConfig(bwd_layout="compact")}
        train_launches, s22_ms, leaf_ms = {}, {}, {}
        for run, rcfg in runs.items():
            tr_r, train_launches[run], out_r, _ = train_path(scene_dir, root, dev, run, rcfg)
            if run == "stream":
                tr, out = tr_r, out_r
                check_trained_render(out, scene_dir, dev)
            else:
                l_s, l_r = float(tr.losses[0]), float(tr_r.losses[0])
                if not math.isclose(l_r, l_s, rel_tol=1e-5):
                    raise AssertionError(f"first loss: {run} run {l_r!r}, stream {l_s!r}")
                log(f"training path: first loss {l_r:.7f} ({run}) and {l_s:.7f} (stream)")
            s22_ms[run] = time_stage22(tr_r, card, run, profiled=run != "dense")
            if run == "compact":  # the two stream backwards from one state, in turns
                k2_cfg = dataclasses.replace(rcfg, bwd_layout="auto")
                turns = [time_stage22(tr_r, card, f"compact run, {lay}", rcfg=c)
                         for lay, c in (("K2", k2_cfg), ("K4", rcfg), ("K4", rcfg),
                                        ("K2", k2_cfg))]
                log("timing: stage-2.2 step from the compact run's state, in turns K2, K4, "
                    "K4, K2: " + ", ".join(f"{x:.3f}" for x in turns) + f" ms [{card}]")
            if run != "compact":
                leaf_ms[run] = time_leaf_events(tr_r, card, run)
            if run != "stream":
                del tr_r

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
            # K4 on the same frame and cotangents, and each backward with its reduce
            cargs = (rows, counts, tstart, toff, ids, *cot, gx, chunk, n)
            k4_ms = cuda_ms(lambda: rk.blend_stream_bwd_compact(*cargs), iters=20, warmup=3)
            k4_cold = cuda_ms(lambda: (flush.zero_(), rk.blend_stream_bwd_compact(*cargs)),
                              iters=10) - f_ms
            k4_plain = cuda_ms(lambda: rk.blend_stream_bwd_compact_plain(*cargs), iters=2)
            log(f"timing: blend_stream_bwd_compact C=4: kernel {k4_ms:.4f} ms/launch "
                f"({k4_cold:.4f} with L2 flushed), plain {k4_plain:.3f} ms/launch, "
                f"{compact['d'].shape[0]} compacted rows [{card}]")
            k2_dev, k4_dev = (device_ms(f, 10, k) for f, k in (
                (lambda: rk.blend_stream_bwd(*bargs), "blend_stream_bwd_kernel"),
                (lambda: rk.blend_stream_bwd_compact(*cargs), "blend_stream_bwd_compact_kernel")))
            log(f"timing: device time by torch.profiler, C=4 frame: K2 kernel {k2_dev:.4f} ms, "
                f"K4 kernel {k4_dev:.4f} ms per launch (the calls above add the wrappers' "
                f"host work: K4's computes the chunk offsets with one host sync) [{card}]")
            k2k3 = lambda: rk.segment_reduce(rk.blend_stream_bwd(*bargs), ids, n)  # noqa: E731
            k4k3 = lambda: rk.segment_reduce(*rk.blend_stream_bwd_compact(*cargs), n)  # noqa: E731
            pair = [cuda_ms(f, iters=20, warmup=3) for f in (k2k3, k4k3, k4k3, k2k3)]
            log(f"timing: backward + reduce, C=4 frame, in turns K2+K3, K4+K3, K4+K3, K2+K3: "
                + ", ".join(f"{x:.4f}" for x in pair) + " ms (K2's wrapper zero-fills d_rows, "
                f"K4's computes the chunk offsets with one host sync) [{card}]")
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
            log("timing: library_ms null for K1, K2, K4, K5 and K6: no single PyTorch call "
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
        k4_b, k4_by = compact_bound(int(counts.sum()), compact["d"].shape[0], rows.shape[1],
                                    counts.shape[0], grad["work"], peak_flops, peak_bytes)
        log(f"bound: blend_stream_bwd_compact C=4: {k4_b:.4f} ms/launch ({k4_by}), kernel "
            f"(device time) at {k4_b / k4_dev:.3f} of it, the call at {k4_b / k4_ms:.3f} "
            f"[{card}]")
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

    main_paths = (render_launches, *train_launches.values())
    total = {k: sum(p[k] for p in main_paths) for k in render_launches}
    log(f"launches on the main paths: render {render_launches}, "
        + ", ".join(f"training ({r}) {v}" for r, v in train_launches.items()))
    log(f"summary: stage-2.2 step ms {s22_ms}; sweep 2 / stage 3 ms per view {leaf_ms}; "
        f"partition against scan max abs err {partition_err:.3e} [{card}]")
    kernels = [
        row("blend_stream_fwd", total["blend_stream_fwd"], k1_err,
            sum(k_ms.values()) / len(k_ms), sum(p_ms.values()) / len(p_ms),
            sum(k1_b) / len(k1_b), max(k1_bound.values())[1], line=562),
        row("blend_stream_bwd", total["blend_stream_bwd"], grad["k2_err"], k2_ms, k2_plain,
            k2_b, k2_by, line=670),
        row("blend_stream_bwd_compact", total["blend_stream_bwd_compact"], compact["k4_err"],
            k4_dev, k4_plain, k4_b, k4_by, line=841),
        row("segment_reduce", total["segment_reduce"],
            max(grad["k3_err"], dense["k3_err"], compact["k43_err"]),
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
