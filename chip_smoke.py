"""Drive the PyTorch port (opengaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

--parent DIR: another checkout of this repository (the parent commit), whose
K2, K4 and K6 are built from its own csrc/ and timed beside this tree's, in
turns, on the same inputs of the render and training frames.

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA kernel of the port (one nvcc per csrc/*.cu, all
     started together), from the sources in the checkout.
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the streams of a full-width frame (1296x968, 200k splats, SH degree 3,
     6-D instance features): the forward blend K1 at C = 4 (RGB + depth) and
     C = 7 (features + depth), bit for bit; the backward replay K2, the
     compact backward K4 (both bit for bit) and the per-splat reduce K3 on
     the C = 4 stream, with the cotangents of an L1 + SSIM loss against the
     view's image, K4 again on the same stream made of flat opaque splats
     (every tile stops after one chunk), K4 + K3 against K2 + K3 per splat,
     and K4 + K3 under torch.cuda.set_sync_debug_mode("error") (no host
     sync). The dense layout's forward K5 and its backward K6 (both bit for
     bit; K6 also on the block made of flat opaque splats, and its rows
     against K2's on the frame's C = 7 stream) and K3 over K6's rows on the
     same frame's C = 7 dense block, with the cotangents of the stage-1 loss
     (separation + cohesion on the view's SAM masks); the sizes K6 writes
     and K3 reads and what the two allocate. A partition render of one root's 5 leaves against the same
     leaves rendered one by one. Then the rasterizer on the card against the
     naive oracle on the CPU, and at 160x120 one stage-0 step, one stage-1
     and one stage-2.1 step in each input layout, one stage-2.2 step in the
     stream, dense and compact configurations, one sweep-2 view, one stage-3
     view and assign_leaf, on the card against the same on the CPU; and the
     SAM mask refiner on tests/test_refiner.py's two-blob scene, in each
     layout, on the card against the CPU (votes and weights to a normalised
     1e-5, refined masks equal).
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
     K3), with bwd_layout="compact" (K1, K4, K3) and, fourth, with
     --enable_multiview_sam_refinement --lazy_load (host-resident views
     decoded from disk per step; the refiner, traced, before step 41: one
     more K1 launch per view; the bundle's SAM ids rewritten); their first
     losses equal the stream run's. The stage-0 and stage-1 step of the
     stream and the lazy run, in turns. A fifth run takes the same schedule
     with the JAX package's options for fixed shapes switched on
     (`blocked_trainer`: autotune_budgets, use_frozen_plans, BLOCK_SIZES =
     (50, 10, 5), so every step but a few runs as a replay of its stage's
     CUDA graph): the same launches (the replays count what the captures
     launched), checks and first loss, its first 20 losses those of the
     stream run. Then the refiner's fused path at
     tools/refine_bench.py's shape (100k splats, 60 views at 648x484, 32
     ids per view, anchor stride 1000), max_per_tile fitted to its
     binning's deepest tile: one K1 launch per view, K1 bit for bit at
     C = 2 on view 0's depth stream, the phase seconds, n_gids, the void
     fraction, the peak device memory and one view's vote and expansion
     passes by torch.profiler.
  6. queries, on a copy of the stream run's trained model: its
     cluster_lang.npz rewritten with a converged-quality table aimed at the
     two leaves that own the most alive splats under the leaf-level scale
     cull (the substitution of tests/test_user_journey.py, since the
     80-iteration table has no leaf a text query could find), then
     `cli.render_by_text.main` for two texts over the 3 views (non-empty
     selections after the KNN mask and the scale cull, RGB and silhouette
     PNGs, one K1 launch per (text, view)), `cli.render_by_click.main` at
     the brightest ins_feat1 pixel of view 0 and at the pixel nearest a
     root whose leaves were clustered (one K1 launch per view each);
     render_selection (RGB and feature payloads), LPIPS on random weights
     with cuDNN's TF32 at torch's default, and evaluate_dirs' PSNR and SSIM
     on the card against the CPU at 160x120; a SIBR viewer round trip
     against a Trainer taking stage-0 steps at full width (the frame's bytes
     equal to a render of its camera, training resumed); the times of
     render_selection alone, LPIPS per full-width view and a viewer frame.
  7. timings (CUDA events after warm-up), each line with the card's name:
     each kernel against its plain version and its bound, K3's call and
     device time in turns with its index_add_ yardstick, K2 + K3 against
     K4 + K3 on the C = 4 frame and K2 + K3, K4 + K3 and K6 + K3 on the
     C = 7 frame, in turns, K1, K2, K4 and K6 on the training frame (the
     stage-1 step's feature pass from the trained state, each held bit for
     bit against its plain version, with its bound) and their deepest tile
     alone, with --parent K2, K4 and K6 beside the parent's on both frames,
     the render, the stage-0 step and its phases, the stage-1 and stage-2.1
     steps in both layouts, the stage-2.2 step of each training run, sweeps
     1 and 2 and stage 3 per view, the root and leaf k-means, and
     torch.profiler's device time by kernel over one render of each view and
     over one step of each stage, which give the card's idle share in each.
  8. fixed shapes: at 160x120 on a trainer over two blobs (`blob_trainer`,
     roots that pass the gates), in the stream, dense and compact
     configurations, each stage's eager step at fixed budgets under
     torch.cuda.set_sync_debug_mode("error") and its captured step
     (Trainer._captured_step, a CUDA graph) against the eager one to K3's
     tolerance, the stage-2.2 step with `ok` true; on the stream run's
     trained state the budget probe and the tuned budgets (every view
     lossless; a stage-1 step at them against the stream sized per frame),
     frozen plans (build time, bytes; stage-1 and stage-2.1 steps through a
     plan against the fresh binning, the render at rescale 0.55 within the
     JAX package's bound, the stage-1 step with and without, in turns),
     each stage's captured step in the three configurations against the
     eager one and, in turns, their wall times, busy times, idle shares and
     kernels per step; the group entries of K5 and K6 bit for bit with
     their plain versions on the training frame's block at G = 1 and 5,
     rasterize_groups against rasterize_scan_groups, and the dense-group
     path (sweep 2 and stage 3 of view 0, 5 captured stage-2.2 steps of
     the blocked trainer) with its launches, and sweep 2 and stage 3 per
     view with group_render="dense".
  9. tile windows, tile bands and the mesh, on the stream run's trained
     state: the budget tuner's window branch (a base config with
     tile_windows > 0: K = WINDOW_K, S from the probe's deepest tile,
     window_extra from its extra windows); on the training frame binned
     under it, S, Tv, the live and dead windows, nothing truncated or
     dropped, K1, K2 and K4 bit for bit with their plain versions on the
     virtual tiles (the dead windows start over NaN rows), K3 over K2's
     rows, the folded tiles within T_EPS_TOL of the unwindowed ones; in
     turns windowed and unwindowed, K1, K2 and K4 device time, the deepest
     walk alone, the fold, and a stage-1 step eager and captured through
     each config's frozen plans (the captured windowed step against the
     eager one). rasterize_banded(bands=4) against rasterize on the render
     and training frames in the stream, dense and compact configurations,
     images and gradients, each band's slots and launches. The mesh at world
     size 1 on NCCL in this process: render_sharded against rasterize,
     bands off and on, 10 sharded stage-0 steps against 10 single-device
     ones, the two steps in turns, scaling_bench(sizes=[1]).
 10. the mesh trainer at world size 1 on NCCL: `cli.train.main` with
     --mesh 1 (Trainer(mesh=...) over a process group of one in this
     process) trains the 80-iteration schedule of phase 5 without its
     opacity reset, the SAM refiner on, through stage 3 and a checkpoint:
     every step sharded (K1, K2, K3), the sweeps and stage 3 through the
     group entry of K5 at the rank's tile offset, the refiner's depth
     renders through K1; the launches of that schedule, the losses, PLYs,
     codebooks, cluster_lang.npz and the checkpoint checked, the roots
     occurring per view and the stage-2.2 loss logged. On the trained state,
     one sharded step of each stage against the single-device step in the
     stream, dense and compact configurations (stage 2.2 on a root whose
     render occurs), and in turns; eval_render against render; sweeps 1 and
     2 and the stage-3 association of each view against the single-device
     ones, and in turns; the sharded refiner's ids against the single-device
     refiner's on the two-blob scene; the group entry of K5 at a tile offset
     bit for bit with its plain version.
Then a JSON line of per-kernel numbers (K5's and K6's rows count their
group entries' launches and errors), the nvidia-smi line, and last the
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
# the refiner phase: tools/refine_bench.py's shape (ScanNet at -r 2)
REFINE_W, REFINE_H = 648, 484
REFINE_SPLATS, REFINE_VIEWS, REFINE_IDS, REFINE_STRIDE = 100_000, 60, 32, 1000
TOL = dict(atol=3e-5, rtol=1e-4)
# K3 sums a splat's slots in atomic order, so its tolerance is relative to
# each field's largest magnitude: |kernel - plain| <= 1e-5 * max|plain field|
# + 1e-4 * |plain|. K2, K4 and K6 sum in a fixed order and match bit for bit.
GRAD_TOL = dict(norm_atol=1e-5, rtol=1e-4)
# fp32 operations per (slot, pixel) pair of the blend, by what the pair needs:
# every pair that must be evaluated (its warp's pixels meet the slot's cull
# box; outside it alpha stays below 1/255, which one test per warp shows):
# dx, dy and the conic's quadratic form (11), the clamp of power (1), expf
# (~8: range reduction, ex2 and scaling without fast math), the power test,
# o * gauss, the 0.99 clamp and the 1/255 test (4)
OPS_EVALUATED = 24
OPS_TESTED = 3  # alpha >= 1/255: 1 - alpha, T * (1 - alpha), the 1e-4 test
OPS_CULL = 4  # per slot and warp: the warp's rectangle against the box
# per staged slot, its cull box (blend_tile.cuh:slot_box): det (3), the
# conditioning bound (7), the tests (5), the level with its log (13), the
# half-extents (8), their margins (12), the edges (4), finiteness (4), the
# opacity test (1)
OPS_BOX = 57


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


def frame_streams(camera, state, rcfg=None):
    """The blend inputs of one view's two render passes, built by the
    render path's own _prepare and gather_rows (rcfg: the rasterizer's
    settings, RasterizeConfig() by default; under tile windows toff holds
    each virtual tile's real tile):
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
                                       rcfg or RasterizeConfig())
        opac = torch.where(proj.valid, state.opacity, 0.0)
        rows = gather_rows(proj.mean2d, proj.conic, opac,
                           torch.cat([payload, proj.depth[:, None]], dim=-1),
                           bins.sorted_gauss)
        vt = (bins.vt_real if bins.vt_real is not None
              else torch.arange(bins.counts.shape[0], device=state.device))
        out[payload.shape[1] + 1] = (rows, bins.counts, bins.tile_start,
                                     vt.to(torch.int32).contiguous(), gx, bins, proj)
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
            worst = max(worst, compare(f"blend_stream_fwd C={C} {name}", x, y, 0.0, 0.0))
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
    k2 = compare("blend_stream_bwd C=4 d_rows", d, d_p, 0.0, 0.0)
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
    features + depth). -> (gdata [T, K, 13], counts, tile_start,
    sorted_gauss, grid_x, n_truncated): tile_start and sorted_gauss are the
    stream the block was gathered from, K6's row positions and K3's ids."""
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
    return (gdata, bins.counts, bins.tile_start, bins.sorted_gauss, gx,
            int(bins.n_truncated))


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


def check_dense_kernels(block, stream, camera, grids, sam_ids, max_masks: int,
                        chunk: int, n: int) -> dict:
    """blend_tiles_fwd (K5), blend_tiles_bwd (K6) and segment_reduce (K3)
    over K6's rows against their plain versions on the card, with stage-1
    cotangents; K6's rows against K2's on the frame's C = 7 stream, from
    which the block was gathered; K6 again on the block made of flat opaque
    splats, whose tiles all stop after one chunk. Logs the sizes of K6's
    output and K3's input, and the device memory K6 + K3 allocate, beside
    the block's. -> {"k5_err", "k6_err", "k3_err", "work_fwd", "work_bwd",
    "cot"}."""
    from opengaussian_tpu_torch.config import OptimizationConfig
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    gdata, counts, tstart, sorted_gauss, gx, _ = block
    T, K, F = gdata.shape
    P = sorted_gauss.shape[0]
    acc, t_final = rk.blend_tiles_fwd(gdata, counts, gx, chunk)
    torch.cuda.synchronize()
    acc_p, t_p, work_f = rk.blend_tiles_fwd_plain(gdata, counts, gx, chunk, count_work=True)
    log("work K5: " + ", ".join(f"{k} {v}" for k, v in work_f.items()))
    k5 = max(compare(f"blend_tiles_fwd C={F - 6} {nm}", x, y, 0.0, 0.0)
             for nm, x, y in (("accum", acc, acc_p), ("t_final", t_final, t_p)))
    cot = stage1_cotangents(camera, grids, acc_p, t_p, sam_ids, max_masks,
                            OptimizationConfig().loss_weight)
    args = (gdata, counts, tstart, P, acc_p, t_p, *cot, gx, chunk)
    d = rk.blend_tiles_bwd(*args)
    torch.cuda.synchronize()
    d_p, work_b = rk.blend_tiles_bwd_plain(*args, count_work=True)
    log("work K6: " + ", ".join(f"{k} {v}" for k, v in work_b.items()))
    k6 = compare(f"blend_tiles_bwd C={F - 6} d_rows", d, d_p, 0.0, 0.0)
    if float(d_p.abs().max()) == 0.0:
        raise AssertionError("K6: the stage-1 loss gave no gradient")
    rows, s_counts, s_tstart, toff = stream[:4]
    if not (torch.equal(s_tstart, tstart) and torch.equal(s_counts, counts)):
        raise AssertionError("the dense block was not gathered from the C=7 stream")
    d2 = rk.blend_stream_bwd(rows, s_counts, s_tstart, toff, acc_p, t_p, *cot, gx, chunk)
    torch.cuda.synchronize()
    if not torch.equal(d, d2):
        raise AssertionError("K6's rows differ from K2's on the stream of the same frame")
    # flat splats (conic 0) of opacity 0.98: every tile stops after its
    # first chunk, so the rows past it stay as the wrapper zeroed them
    flat = gdata.clone()
    flat[..., 2:5] = 0.0
    flat[..., 5] = 0.98
    acc_o, t_o = rk.blend_tiles_fwd(flat, counts, gx, chunk)
    args_o = (flat, counts, tstart, P, acc_o, t_o, *cot, gx, chunk)
    d_o = rk.blend_tiles_bwd(*args_o)
    torch.cuda.synchronize()
    k6 = max(k6, compare(f"blend_tiles_bwd C={F - 6} d_rows, flat opaque splats", d_o,
                         rk.blend_tiles_bwd_plain(*args_o), 0.0, 0.0))
    del flat, acc_o, t_o, d_o
    # K3 over K6's rows; what the dense backward allocates
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    per = rk.segment_reduce(rk.blend_tiles_bwd(*args), sorted_gauss, n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"K6 + K3, dense backward: K6 writes [{P}, {F}] rows ({P * F * 4 / 1e6:.1f} MB) "
        f"for {int(counts.sum())} live slots and K3 reduces those {P} rows, where the "
        f"block [T, K, F] = {list(gdata.shape)} holds {T * K} slots "
        f"({gdata.numel() * 4 / 1e6:.1f} MB); K6 + K3 allocate at most {peak / 1e6:.1f} MB "
        f"on the card; K6's rows equal K2's on the frame's stream")
    if peak >= gdata.numel() * 4:
        raise AssertionError(f"K6 + K3 allocated {peak} bytes, a block's worth")
    per_p = rk.segment_reduce_plain(d_p, sorted_gauss, n)
    k3 = compare("segment_reduce per-splat (K6's rows)", per, per_p, grad_atol(per_p),
                 GRAD_TOL["rtol"])
    return dict(k5_err=k5, k6_err=k6, k3_err=k3, work_fwd=work_f, work_bwd=work_b,
                cot=cot)


def poison_allocator(rows: int, F: int, dev) -> None:
    """Leave NaN-filled blocks the size of K4's two outputs in PyTorch's
    caching allocator, which the wrapper's torch.empty then reuses: a row
    or an id the kernel fails to write shows as NaN or as a wrong id."""
    torch.cuda.synchronize()
    blocks = [torch.full((rows, F), float("nan"), device=dev),
              torch.full((rows,), float("nan"), device=dev)]
    del blocks


def check_compact_kernel(stream, cot, chunk: int, n: int, d_rows_k2) -> dict:
    """blend_stream_bwd_compact (K4) against its plain version on the card,
    bit for bit (the rows of the tiles' range, the ids of every row: n past
    it), on one frame's stream and loss cotangents, and on the same stream
    with near-opaque splats, where the tiles stop early and K4 must zero the
    live rows past the stop itself; then K4 + K3 against K2 + K3 per splat.
    K4 and K3 run under torch.cuda.set_sync_debug_mode("error"): a host
    sync on their path fails the run. -> {"k4_err", "k43_err", "d", "ids",
    "nc_rows"}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    rows, counts, tstart, toff, gx, bins, _ = stream
    nc_rows = rk.compact_offsets(counts, chunk)[1] * chunk
    R = rk.compact_rows(rows.shape[0], counts.shape[0], chunk)
    args = (rows, counts, tstart, toff, bins.sorted_gauss, *cot, gx, chunk, n)
    poison_allocator(R, rows.shape[1], rows.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, ids = rk.blend_stream_bwd_compact(*args)
        per4 = rk.segment_reduce(d, ids, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"K4 + K3 ran under torch.cuda.set_sync_debug_mode('error'): no host sync; "
        f"{R} rows sized from P = {rows.shape[0]} and T = {counts.shape[0]}, of which "
        f"the tiles' {nc_rows // chunk} chunks fill {nc_rows}")
    d_p, ids_p = rk.blend_stream_bwd_compact_plain(*args)
    if d.shape != d_p.shape or d.shape[0] != R:
        raise AssertionError(f"K4: {tuple(d.shape)} rows, plain {tuple(d_p.shape)}, want {R}")
    k4 = compare("blend_stream_bwd_compact C=4 d_rows", d[:nc_rows], d_p[:nc_rows], 0.0,
                 0.0)
    if not torch.equal(ids, ids_p) or not bool((ids[nc_rows:] == n).all()):
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
    poison_allocator(R, rows.shape[1], rows.device)
    d_o, ids_o = rk.blend_stream_bwd_compact(*args_o)
    torch.cuda.synchronize()
    d_op, ids_op = rk.blend_stream_bwd_compact_plain(*args_o)
    k4 = max(k4, compare("blend_stream_bwd_compact C=4 d_rows, flat opaque splats",
                         d_o[:nc_rows], d_op[:nc_rows], 0.0, 0.0))
    if not torch.equal(ids_o, ids_op):
        raise AssertionError("K4, flat opaque splats: the ids differ from the plain "
                             "version's")
    past = int(torch.clamp(counts - chunk, min=0).sum())
    log(f"K4, flat opaque splats: every tile stops after its first chunk, {past} of "
        f"{int(counts.sum())} live rows past the stop, zero-written by K4")
    if past == 0:
        raise AssertionError("K4: no tile of the frame is deeper than one chunk")
    per2 = rk.segment_reduce(d_rows_k2, bins.sorted_gauss, n)
    torch.cuda.synchronize()
    k43 = compare("K4 + K3 against K2 + K3 per splat", per4, per2, grad_atol(per2),
                  GRAD_TOL["rtol"])
    log(f"K4: {d.shape[0]} compacted rows for {int(counts.sum())} live slots, "
        f"{int((ids == n).sum())} rows with id n ({R - nc_rows} past the tiles' range)")
    return dict(k4_err=k4, k43_err=k43, d=d, ids=ids, nc_rows=nc_rows)


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


def refiner_two_blobs():
    """tests/test_refiner.py's two-blob scene, built by the port on the CPU:
    two opaque blobs of 40 splats seen by two 64x48 cameras, under per-view
    SAM ids (left, right) that view 1 swaps and that the rendered silhouette
    gates. -> (state, [camera, camera], SAM ids [2, 48, 64] int64, config)."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

    cfg = RasterizeConfig(max_per_tile=64, chunk=32)
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(0, 0.05, (40, 3)) + [-0.6, 0.0, 3.0],
                          rng.normal(0, 0.05, (40, 3)) + [0.6, 0.0, 3.0]]).astype(np.float32)
    cols = np.concatenate([np.tile([1.0, 0, 0], (40, 1)),
                           np.tile([0, 0, 1.0], (40, 1))]).astype(np.float32)
    st = G.create_from_pcd(pts, cols, capacity=128, seed=0, device="cpu")
    st = dataclasses.replace(st, logit_opacity=torch.where(
        st.alive, G.inverse_sigmoid(torch.tensor(0.995)), -10.0))
    cams = [Camera.from_fov(np.eye(3), np.asarray(t), 1.0, 0.8, 64, 48)
            for t in ([0.0, 0.0, 0.0], [0.05, 0.0, 0.0])]
    sam = np.zeros((2, 48, 64), np.int64)
    left = np.arange(64)[None, :] < 32
    with torch.no_grad():
        for v, cam in enumerate(cams):
            r = rasterize(cam, st.means, build_cov3d(st.scales, st.quats), st.opacity,
                          torch.zeros((st.capacity, 1)), torch.zeros(1), cfg)
            ids = np.where(left, 1, 2) if v == 0 else np.where(left, 2, 1)
            sam[v] = np.where(r.alpha.numpy() > 0.3, ids, 0)
    return st, cams, sam, cfg


def check_refiner_against_cpu(dev, layout: str = "stream") -> dict:
    """On refiner_two_blobs' scene, the SAM refiner on the card against the
    same on the CPU: each view's votes (splat_id_votes on the CPU's depth
    map) and its stage-2 weights on seeded inputs to a normalised 1e-5 (the
    card's index_add_ sums in atomic order), the visibility equal, and
    refine_sam_masks' refined masks equal, with one depth render per view
    through the layout's forward kernel (K1, or K5 for "dense").
    -> {"votes", "weights"}: the largest normalised errors."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import rasterize
    from opengaussian_tpu_torch.refine import sam_refiner as sr

    st, cams, sam, cfg = refiner_two_blobs()
    cfg = dataclasses.replace(cfg, pallas_input=layout)
    st_g = to_device(st, dev)
    M = int(sam.max())
    errs = {"votes": 0.0, "weights": 0.0}
    rng = np.random.default_rng(4)
    for v, cam in enumerate(cams):
        with torch.no_grad():
            r = rasterize(cam, st.means, build_cov3d(st.scales, st.quats), st.opacity,
                          torch.zeros((st.capacity, 1)), torch.zeros(1), cfg)
        depth = r.depth / torch.clamp(r.alpha, min=1e-6)
        vc, visc = sr.splat_id_votes(st, cam, torch.as_tensor(sam[v]), depth, M, cfg)
        vg, visg = sr.splat_id_votes(st_g, cam, torch.as_tensor(sam[v], device=dev),
                                     depth.to(dev), M, cfg)
        if not torch.equal(visg.cpu(), visc):
            raise AssertionError(f"refiner view {v}: visibility differs on the card")
        gid = torch.as_tensor(np.where(st.alive.numpy(), rng.integers(0, M + 3, 128), 0))
        wargs = (gid, torch.as_tensor(rng.random(128) < 0.7),
                 torch.as_tensor(np.where(sam[v] > 0, sam[v] + 1, 0)),
                 torch.as_tensor(rng.integers(0, 5, M + 2).astype(np.float32)), M + 2, cfg)
        wc = sr.pixel_weight_accumulation(st, cam, *wargs)
        wg = sr.pixel_weight_accumulation(st_g, cam, *[
            a.to(dev) if isinstance(a, torch.Tensor) else a for a in wargs])
        errs["votes"] = max(errs["votes"], normalised_err(vg, vc))
        errs["weights"] = max(errs["weights"], normalised_err(wg, wc))
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"refiner on the card against the CPU, {layout}: normalised "
                             f"errors {errs}")
    wrappers = zero_launches()
    got = sr.refine_sam_masks(st_g, cams, sam, cfg, anchor_stride=1)
    fwd = {"blend_tiles_fwd": len(cams)} if layout == "dense" else {}
    read_launches(wrappers, 0 if fwd else len(cams), f"refiner, {layout} layout", **fwd)
    want = sr.refine_sam_masks(st, cams, sam, cfg, anchor_stride=1)
    if not np.array_equal(got, want) or not (want > 0).any():
        raise AssertionError(f"refiner, {layout} layout: the card's refined masks differ "
                             f"from the CPU's in {int((got != want).sum())} pixels")
    log(f"refiner, {layout} layout, two-blob scene: votes and weights on the card against "
        f"the CPU to a normalised {errs['votes']:.2e} and {errs['weights']:.2e}, "
        f"visibility and refined masks equal ({len(np.unique(want[want > 0]))} ids)")
    return errs


def refine_scene(dev):
    """tools/refine_bench.py:51-84's scene, built here: REFINE_SPLATS splats
    filling a room volume, ~40% of them past the 0.99 anchor opacity (a
    trained scene's top end), REFINE_VIEWS cameras on an arc at
    REFINE_W x REFINE_H, and per-view blocky SAM grids of REFINE_IDS ids
    whose numbering shifts per view (so stage 1 has cross-view work), with an
    invalid border stripe. -> (state, cameras, SAM ids [V, H, W] int16)."""
    from opengaussian_tpu_torch.cameras import Camera
    from opengaussian_tpu_torch.models import gaussians as G

    rng = np.random.default_rng(0)
    n = REFINE_SPLATS
    pts = np.stack([rng.normal(0, 1.2, n), rng.normal(0, 0.9, n),
                    rng.uniform(2.0, 9.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gs = G.create_from_pcd(pts, cols, capacity=n, seed=0, device=dev)
    op = np.where(rng.uniform(size=n) < 0.4, 6.0, rng.normal(0.0, 2.0, n))
    gs = dataclasses.replace(gs, log_scales=gs.log_scales + math.log(0.05),
                             logit_opacity=torch.as_tensor(op.astype(np.float32), device=dev))
    W, H, ids = REFINE_W, REFINE_H, REFINE_IDS
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gh = max(1, int(np.sqrt(ids / 2)))
    gw = max(1, ids // gh)
    block = ((yy * gh // H) * gw + (xx * gw // W)) % ids
    cams, sams = [], []
    for v in range(REFINE_VIEWS):
        ang = 0.9 * (v / max(REFINE_VIEWS - 1, 1) - 0.5)
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.array([0.8 * np.sin(2 * ang), 0.1 * np.cos(3 * ang), 0.0], np.float32)
        cams.append(Camera.from_fov(R, t, 1.1, 0.9, W, H))
        s = ((block + v * 7) % ids + 1).astype(np.int16)
        s[:6] = 0
        sams.append(s)
    return gs, cams, np.stack(sams)


def depth_stream(camera, state, rcfg):
    """The blend input of the refiner's depth render of one view (payload
    zeros [N, 1] and depth: C = 2), built by the render path's own _prepare
    and gather_rows. -> (rows, counts, tstart, toff, grid_x)."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import _prepare, gather_rows

    camera = camera.to(state.device)
    proj, bins, (gx, _) = _prepare(camera, state.means, build_cov3d(state.scales, state.quats),
                                   state.opacity, rcfg)
    opac = torch.where(proj.valid, state.opacity, 0.0)
    payload = torch.cat([torch.zeros((state.capacity, 1), device=state.device),
                         proj.depth[:, None]], dim=-1)
    rows = gather_rows(proj.mean2d, proj.conic, opac, payload, bins.sorted_gauss)
    toff = torch.arange(bins.counts.shape[0], dtype=torch.int32, device=state.device)
    return rows, bins.counts, bins.tile_start, toff, gx


def refine_phase(dev, card: str) -> dict:
    """The refiner's fused path (no trace: the per-pixel argmax stays on the
    card) at tools/refine_bench.py's shape, through refine_sam_masks, the
    function the trainer calls. max_per_tile is fitted to the deepest tile of
    the refiner's own binning (no opacities: the 3-sigma rect), so no slot
    is truncated. Checks exactly one K1 launch per view and no other kernel,
    K1 bit for bit with its plain version on view 0's depth stream (C = 2),
    and refined ids in [-1, n_gids]; logs the phase seconds, n_gids, the
    void fraction, the peak device memory, and the device time of one
    view's vote and expansion passes (torch.profiler, every kernel).
    -> those numbers."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, deepest_tile, rasterize
    from opengaussian_tpu_torch.refine import sam_refiner as sr

    t0 = time.perf_counter()
    gs, cams, sam = refine_scene(dev)
    chunk = RasterizeConfig().chunk
    with torch.no_grad():
        cov3d = build_cov3d(gs.scales, gs.quats)
        deep = [deepest_tile(c, gs.means, cov3d, None, RasterizeConfig()) for c in cams]
        v_deep = int(np.argmax(deep))
        rcfg = RasterizeConfig(max_per_tile=-(-max(deep) // chunk) * chunk)
        _, bins, _, _ = sr._footprint_bins(gs, cams[v_deep].to(dev), rcfg)
    n_trunc = int(bins.n_truncated)
    log(f"refiner phase: {REFINE_SPLATS} splats, {REFINE_VIEWS} views {REFINE_W}x"
        f"{REFINE_H}, {REFINE_IDS} ids per view, anchor stride {REFINE_STRIDE}; set up in "
        f"{time.perf_counter() - t0:.1f} s; the refiner binning's deepest tile {max(deep)} "
        f"(view {v_deep}; {min(deep)} in the shallowest view), max_per_tile "
        f"{rcfg.max_per_tile}, n_truncated {n_trunc} in that view")
    if n_trunc != 0:
        raise AssertionError("refiner phase: the fitted max_per_tile truncated a tile")
    with torch.no_grad():
        k1_err, _ = check_kernel_against_plain({2: depth_stream(cams[0], gs, rcfg)}, chunk)

    expand, first = sr.pixel_weight_expand, {}

    def recording(*args):  # the expansion's inputs: n_gids and view 0's arguments
        first.setdefault("args", args)
        return expand(*args)

    sr.pixel_weight_expand = recording
    try:
        wrappers = zero_launches()
        # the refiner's own peak: what it allocates above what the earlier
        # phases still hold (the trained trainers, their captured graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        timings = {}
        t0 = time.perf_counter()
        refined = sr.refine_sam_masks(gs, cams, sam, rcfg, anchor_stride=REFINE_STRIDE,
                                      timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        peak_abs = torch.cuda.max_memory_allocated()
        peak = peak_abs - base
        launches = read_launches(wrappers, REFINE_VIEWS, "refiner phase")
    finally:
        sr.pixel_weight_expand = expand
    n_gids = first["args"][6]
    void = float((refined < 0).mean())
    if refined.shape != sam.shape or refined.min() < -1 or refined.max() > n_gids or \
            not (refined > 0).any():
        raise AssertionError(f"refiner phase: refined {refined.shape}, ids "
                             f"{refined.min()}..{refined.max()} for {n_gids} global ids")
    device_s = sum(v for k, v in timings.items() if k.startswith("device"))
    log(f"refiner phase: {total:.3f} s in all, by phase "
        + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f" (device phases {device_s:.3f} s, each ending in its copy to the host); "
        f"n_gids {n_gids}, void fraction {void:.4f}, peak device memory of the refiner "
        f"{peak / 2**30:.3f} GiB (peak less the {base / 2**30:.3f} GiB held before it; "
        f"{peak_abs / 2**30:.3f} GiB in all), launches {launches} [{card}]")
    # one view's vote and expansion passes alone, every kernel they launch
    with torch.no_grad():
        r = rasterize(cams[0], gs.means, cov3d, gs.opacity,
                      torch.zeros((gs.capacity, 1), device=dev), torch.zeros(1, device=dev),
                      rcfg)
        depth = r.depth / torch.clamp(r.alpha, min=1e-6)
    sam0, M = torch.as_tensor(sam[0], device=dev), int(sam.max())
    votes_ms = device_ms(lambda: sr.splat_id_votes(gs, cams[0], sam0, depth, M, rcfg), 3)
    expand_ms = device_ms(lambda: expand(*first["args"]), 3)
    votes_wall = cuda_ms(lambda: sr.splat_id_votes(gs, cams[0], sam0, depth, M, rcfg), 3)
    expand_wall = cuda_ms(lambda: expand(*first["args"]), 3)
    log(f"timing: refiner passes of view 0 ({REFINE_W}x{REFINE_H}, max_per_tile "
        f"{rcfg.max_per_tile}): votes {votes_ms:.3f} ms device time ({votes_wall:.3f} ms a "
        f"call), expansion over {n_gids} global ids {expand_ms:.3f} ms device time "
        f"({expand_wall:.3f} ms a call) [{card}]")
    return dict(total_s=total, timings=timings, n_gids=n_gids, void=void, peak=peak,
                launches=launches, k1_err=k1_err, votes_ms=votes_ms, expand_ms=expand_ms,
                deepest=max(deep), max_per_tile=rcfg.max_per_tile)


def profile(fn, n: int, what: str, counts: dict | None = None) -> tuple[float, float]:
    """torch.profiler over n calls of fn: device time by kernel.
    -> (device busy ms per call, the union of the kernels' intervals; host
    wall ms per call of the same profiled calls, to the last kernel's end).
    counts: receives "launches", the kernels per call."""
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
    if counts is not None:
        counts["launches"] = round(len(kernels) / n)
    log(f"profile {what}: device busy {busy_ms:.3f} ms, first kernel start to last "
        f"kernel end {span_ms:.3f} ms, host wall {wall_ms:.3f} ms, "
        f"{len(kernels) / n:.0f} kernel launches (per {what})")
    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile {what}:   {us / 1e3 / n:8.4f} ms  {k[:90]}")
    return busy_ms, wall_ms


def device_ms(fn, n: int, *names: str) -> float:
    """Device time per call of the kernels whose names hold one of `names`,
    by torch.profiler over n calls: the kernels alone, without the host work
    of their wrapper. Each name's time is its mean over the launches the
    profiler recorded (it can miss one of a window, and now and then a
    whole window, which is then profiled again, up to 3 times), times its
    launches per call. With no names, every device event of the window, per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if all(any(name in e.name for e in events) for name in names):
            break
        log(f"profile: a window of {n} calls recorded none of {names}; profiling again")
    if not names:
        return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / n
    total = 0.0
    for name in names:
        us = [e.time_range.end - e.time_range.start for e in events if name in e.name]
        if not us:
            raise AssertionError(f"the profiler recorded no {name}")
        per_call = max(1, round(len(us) / n))
        if len(us) != per_call * n:
            log(f"profile: {len(us)} {name} launches recorded of {n} calls")
        total += sum(us) / len(us) * per_call / 1e3
    return total


def walk_ops(work) -> int:
    """The operations a tile walk needs before any compositing, from the
    plain version's work counts: a cull box per staged slot, a box test per
    slot and warp, the evaluation of each pair in a box, the transmittance
    test of each pair past 1/255."""
    return (work["boxes"] * OPS_BOX + work["box_tests"] * OPS_CULL
            + work["in_box"] * OPS_EVALUATED + work["tested"] * OPS_TESTED)


def fwd_bound(name, live: int, F: int, T: int, n_index: int, work, peak_flops,
              peak_bytes) -> tuple[float, str]:
    """A forward blend's least time per launch (K1, K5): the larger of the
    bytes moved over the HBM rate (each of the `live` slot rows read once,
    n_index [T] int32 tables, accum and t_final written once) and the
    operations this frame's data needs (from the plain version's work
    counts) over the fp32 rate."""
    C = F - 6
    moved = live * F * 4 + n_index * T * 4 + T * 256 * C * 4 + T * 256 * 4
    ops = walk_ops(work) + work["blended"] * ops_blended(C)
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
    ops = walk_ops(work) + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1)
    return bound_of(name, moved, ops, peak_flops, peak_bytes)


def reduce_bound(d_rows, n, peak_flops, peak_bytes) -> tuple[float, str]:
    """K3: rows and ids read once, [n, F] written once; one add per element."""
    R, F = d_rows.shape
    return bound_of("segment_reduce", R * F * 4 + R * 4 + n * F * 4, R * F,
                    peak_flops, peak_bytes)


def launch_counts() -> dict:
    """{wrapper: the module attribute whose .launches it counts}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    return {w.__name__: w for w in rk.KERNEL_WRAPPERS}


def expected_launches(tr, rcfg) -> dict:
    """Each kernel's launches on the training path, from the schedule: one
    forward and one backward per step; sweep 1 (one render per view) at the
    entries to stages 2.1 and 2.2; sweep 2 at stage-2.2 entry, one render per
    root and view; stage 3, per view one partition render per root (stream)
    or one render per leaf (dense); with the SAM refiner, one depth render
    per view before stage 1."""
    o, V = tr.cfg.opt, tr.bundle.num_views
    k1, k2 = o.root_node_num, o.leaf_node_num
    dense = rcfg.pallas_input == "dense"
    fwd = "blend_tiles_fwd" if dense else "blend_stream_fwd"
    bwd = ("blend_tiles_bwd" if dense else
           "blend_stream_bwd_compact" if rcfg.bwd_layout == "compact" else "blend_stream_bwd")
    want = dict.fromkeys(launch_counts(), 0)
    want[fwd] = TRAIN_ITERS + 2 * V + k1 * V + (k1 * k2 if dense else k1) * V
    if o.enable_multiview_sam_refinement:
        want[fwd] += V
    want[bwd] = want["segment_reduce"] = TRAIN_ITERS
    return want


def root_alpha_peaks(tr) -> str:
    """Sweep 2's cluster renders of view 0 on the trainer's state (the
    better_vis scale cull, origin features; a sharded state is whole at world
    size 1): each root's alpha peak, which must pass 0.8 for the root to
    occur. -> "min / median / max" over the roots."""
    from opengaussian_tpu_torch.render import render_clusters

    k1 = tr.cfg.opt.root_node_num
    with torch.no_grad():
        out = render_clusters(tr.bundle.camera(0), tr.state, tr.bg, tr.kms.cls_ids,
                              torch.arange(k1, device=tr.device), tr.rcfg, origin_feat=True,
                              better_vis=True, scale_limit=0.5, min_points=100)
    peak = out.cluster_silhouettes.flatten(1).max(dim=1).values
    return (f"{float(peak.min()):.3f} / {float(peak.median()):.3f} / "
            f"{float(peak.max()):.3f}")


def train_path(scene_dir: str, root: str, dev, name: str, rcfg,
               extra: tuple = (), trainer=None) -> tuple:
    """The training main path: cli.train.main for TRAIN_ITERS iterations
    through stages 0, 1, 2.1 and 2.2, then stage 3 (rcfg: the rasterizer's
    settings; extra: more flags of cli.train), every kernel's launches
    counted around it. Checks the launches, the losses, the geometry across
    the feature stages, the codebooks, cluster_lang.npz and the checkpoint.
    With the SAM refiner, the trainer's call of refine_sam_masks is wrapped
    to keep the SAM ids it was given, its phase seconds and its wall time in
    the trainer's `refined` attribute. trainer: what cli.train constructs in
    place of its Trainer (`blocked_trainer`).
    -> (trainer, {kernel: launches}, output dir, seconds)."""
    from opengaussian_tpu_torch.cli import train as cli_train
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply
    from opengaussian_tpu_torch.train import checkpoint, loop
    from opengaussian_tpu_torch.utils.codebook import load_codebook

    out = os.path.join(root, f"trained_{name}")
    refine, real_refine = {}, loop.refine_sam_masks

    def timed_refine(gs, cams, sam_ids, config, **kw):
        refine.update(before=sam_ids.copy(), timings={}, capacity=gs.capacity,
                      config=config)
        t = time.perf_counter()
        ids = real_refine(gs, cams, sam_ids, config, timings=refine["timings"], **kw)
        refine["seconds"] = time.perf_counter() - t
        return ids

    loop.refine_sam_masks = timed_refine
    real_trainer = cli_train.Trainer
    cli_train.Trainer = trainer or real_trainer
    try:
        wrappers = launch_counts()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        flags = [x for k, v in STAGE_ENDS.items() for x in (f"--{k}", str(v))]
        tr = cli_train.main(
            ["-s", scene_dir, "-m", out, "--iterations", str(TRAIN_ITERS), *flags,
             "--densify_from_iter", "10", "--densification_interval", "10",
             "--opacity_reset_interval", "30", "--leaf_update_fr", str(LEAF_UPDATE_FR),
             "--checkpoint_iterations", str(TRAIN_ITERS), *extra], device=dev, rcfg=rcfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        loop.refine_sam_masks = real_refine
        cli_train.Trainer = real_trainer
    tr.refined = refine
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
        f"{tr.pseudo.cluster_occur.sum(dim=1).tolist()}, the roots' alpha peaks in view 0 "
        f"(min / median / max; sweep 2 needs 0.8) {root_alpha_peaks(tr)}")
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


def check_refined_run(tr, out: str, card: str) -> dict:
    """The SAM refiner's training run: the refiner ran once, on the state
    before the first stage-1 step; the bundle's SAM ids were rewritten
    (changed, none negative), max_masks is a multiple of 8 that holds them,
    and refine_trace/ holds the trace's artifacts. Logs the refiner's phase
    seconds, n_gids, the void fraction, and per view the deepest tile of the
    refiner's own binning (no opacities: the 3-sigma rect) with the slots
    that max_per_tile, fitted to the training binning, truncated there (the
    geometry is frozen past stage 0, so the final state bins as the
    refiner's did). -> those numbers."""
    from opengaussian_tpu_torch.refine import sam_refiner as sr

    ref = tr.refined
    if "seconds" not in ref:
        raise AssertionError("refined run: the trainer did not call the refiner")
    after = tr.bundle.sam_ids
    after = after.cpu().numpy() if isinstance(after, torch.Tensor) else np.asarray(after)
    before, V = ref["before"], tr.bundle.num_views
    if np.array_equal(before, after) or after.min() < 0 or tr.bundle.max_masks % 8 or \
            tr.bundle.max_masks < after.max():
        raise AssertionError(f"refined run: ids {after.min()}..{after.max()}, changed "
                             f"{not np.array_equal(before, after)}, max_masks "
                             f"{tr.bundle.max_masks}")
    trace = os.path.join(out, "refine_trace")
    want = {"stage1_sync.npz", "summary.json",
            *(f"{k}_{v}.png" for k in ("depth", "dominant", "refined") for v in range(V))}
    if not want <= set(os.listdir(trace)):
        raise AssertionError(f"refined run: {trace} lacks {want - set(os.listdir(trace))}")
    with open(os.path.join(trace, "summary.json")) as f:
        n_gids = json.load(f)["n_global_ids"]
    void = float((after == 0).mean())  # the refiner's void (-1) is the id 0 here
    with torch.no_grad():
        bins = [sr._footprint_bins(tr.state, tr.bundle.camera(v).to(tr.device),
                                   ref["config"])[1] for v in range(V)]
    log(f"refined run: the refiner's binning at max_per_tile "
        f"{ref['config'].max_per_tile}: deepest tile per view "
        f"{[int(b.deepest) for b in bins]}, slots truncated per view "
        f"{[int(b.n_truncated) for b in bins]}")
    log(f"refined run: the refiner took {ref['seconds']:.3f} s on capacity "
        f"{ref['capacity']} before step {STAGE_ENDS['start_ins_feat_iter'] + 1}, by phase "
        + ", ".join(f"{k} {v:.3f}" for k, v in ref["timings"].items())
        + f" (traced: the weights go to the host); n_gids {n_gids}, void fraction "
        f"{void:.4f} (before {float((before == 0).mean()):.4f}), max_masks "
        f"{tr.bundle.max_masks}, ids {len(np.unique(after))} distinct [{card}]")
    return dict(seconds=ref["seconds"], timings=ref["timings"], n_gids=n_gids, void=void)


def time_view_steps(tr, card: str, name: str) -> dict:
    """Stage-0 and stage-1 step time from a trained state, through the
    trainer's own view store (10 steps between two CUDA events, each from the
    same state) through Trainer.view, as its _run_single takes them: a
    host-resident trainer first copies each step's view window to the card
    (and, lazily loaded, decodes it from disk). -> {"0": ms, "1": ms}."""
    from opengaussian_tpu_torch.train import loop

    o, V = tr.cfg.opt, tr.bundle.num_views

    def s0(i):
        b, j = tr.view(tr.bundle, i % V)
        loop.stage0_step(tr.state, tr.adam, tr.stats, b, j, STAGE_ENDS["start_ins_feat_iter"],
                         tr.bg, tr.spatial_lr_scale, tr.rcfg, o)

    def s1(i):
        b, j = tr.view(tr.bundle, i % V)
        loop.stage1_step(tr.state, tr.adam, b, j, o.start_ins_feat_iter + 1, tr.bg, 1.0,
                         tr.rcfg, o, tr.any_alpha)

    out = {}
    for stage, fn in (("0", s0), ("1", s1)):
        i = iter(range(1000))
        out[stage] = cuda_ms(lambda: fn(next(i)), iters=10)
    log(f"timing: {name} run, views {'in host memory' if tr.save_memory else 'on the card'}"
        f": stage-0 step {out['0']:.3f} ms, stage-1 step {out['1']:.3f} ms (capacity "
        f"{tr.state.capacity}) [{card}]")
    return out


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
        f"{'one partition render per root' if tr.rcfg.pallas_input == 'stream' else 'one group render per root' if tr.rcfg.group_render == 'dense' else 'one render per leaf'}"
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


# --- fixed budgets, frozen plans, captured steps and dense group renders ---

BLOCKS = (50, 10, 5)  # Trainer.BLOCK_SIZES of the blocked training run
K3_TOL = 1e-5  # normalised: K3's atomic order changes from run to run
STAGES = ("0", "1", "2.1", "2.2")
# an iteration of each stage: the step's learning rates and SH degree
STEP_ITS = {"0": 5, "1": STAGE_ENDS["start_ins_feat_iter"] + 5,
            "2.1": STAGE_ENDS["start_root_cb_iter"] + 5,
            "2.2": STAGE_ENDS["start_leaf_cb_iter"] + 5}
LAYOUTS = {"stream": {}, "dense": {"pallas_input": "dense"},
           "compact": {"bwd_layout": "compact"}}


def blob_trainer(dev, rcfg, out_dir: str):
    """A Trainer at 160x120 over blob_scene (one view, its two blobs roots 0
    and 1 under two SAM masks), set up as at stage-2.2 entry: both roots'
    leaves clustered, leaf-mode pseudo labels in which both roots occur, so
    a stage-2.2 step of root 1 has `ok` true and a nonzero gradient; fixed
    budgets (autotune_budgets) tuned to the state. -> the Trainer."""
    from opengaussian_tpu_torch.config import Config, OptimizationConfig
    from opengaussian_tpu_torch.data.dataset import Scene, View
    from opengaussian_tpu_torch.models import gaussians as G
    from opengaussian_tpu_torch.models import optimizer as opt_mod
    from opengaussian_tpu_torch.ops import kmeans as km
    from opengaussian_tpu_torch.train import loop
    from opengaussian_tpu_torch.train import pseudo as pseudo_mod

    W, H, k1, k2 = 160, 120, 2, 3
    base, roots, cam, sam = blob_scene(W, H)
    n = int(base.num_alive)
    view = View(camera=cam, image_name="blob", gt_image=np.full((H, W, 3), 0.5, np.float32),
                sam_mask=np.stack([sam - 1] * 4))
    scene = Scene([view], [], base.means[:n].numpy(), np.full((n, 3), 0.5, np.float32),
                  1.0, out_dir)
    opt = OptimizationConfig(sam_level=0, root_node_num=k1, leaf_node_num=k2,
                             leaf_update_fr=LEAF_UPDATE_FR, **STAGE_ENDS)
    tr = loop.Trainer(scene, Config(opt=opt), out_dir, rcfg=rcfg, device=dev,
                      autotune_budgets=True)
    tr.save_intermediate = False
    st = to_device(base, dev)
    tr.state, tr.adam = st, opt_mod.init(st.params())
    tr.stats = G.DensifyStats.zeros(st.capacity, dev)
    kms = dataclasses.replace(km.KMeansState.create(st.capacity, k1, k2, dev),
                              cls_ids=roots.to(dev))
    tr.pseudo = pseudo_mod.construct_pseudo_labels(
        st, [cam], tr.bundle.sam_ids, tr.bg, tr.bundle.max_masks, rcfg, mode="leaf",
        cls_ids=kms.cls_ids, k1=k1, k2=k2)
    kms = dataclasses.replace(kms, leaf_sub_num=tr.pseudo.leaf_sub_num)
    for r in range(k1):
        member = (kms.cls_ids == r) & st.alive
        kms = km.assign_leaf(kms, st.ins_feat, st.alive, r, k2, init=True,
                             init_centers=st.ins_feat[member][:k2])
    tr.kms = kms
    tr.iteration = STAGE_ENDS["start_leaf_cb_iter"]
    tr._tune_budgets()  # the frame's and, past stage 2.1's entry, the roots' budgets
    if not bool(tr.pseudo.cluster_occur.all()):
        raise AssertionError(f"blob trainer: roots occurring {tr.pseudo.cluster_occur}")
    return tr


def eager_step(tr, stage: str, vi: int = 0, rescale: float = 1.0, root: int = 1,
               rcfg=None, frozen=None):
    """One eager step of `stage` from the trainer's state (which it does not
    change), at STEP_ITS[stage], view vi, the trainer's background; the root
    as a device tensor (no host copy). -> (state, adam, stats or None, loss,
    n_lost, ok or None)."""
    from opengaussian_tpu_torch.train import loop

    o, it, rcfg = tr.cfg.opt, STEP_ITS[stage], rcfg or tr.rcfg
    if stage == "0":
        st, ad, sa, loss, _p, lost = loop.stage0_step(
            tr.state, tr.adam, tr.stats, tr.bundle, vi, it, tr.bg, tr.spatial_lr_scale,
            rcfg, o)
        return st, ad, sa, loss, lost, None
    if stage == "1":
        st, ad, loss, lost = loop.stage1_step(tr.state, tr.adam, tr.bundle, vi, it, tr.bg,
                                              rescale, rcfg, o, tr.any_alpha, frozen=frozen)
        return st, ad, None, loss, lost, None
    feat = tr.pseudo.feat[vi]
    if stage == "2.1":
        st, ad, loss, lost = loop.stage21_step(tr.state, tr.adam, tr.kms, tr.bundle, vi, it,
                                               tr.bg, rescale, feat, rcfg, o, tr.any_alpha,
                                               frozen=frozen)
        return st, ad, None, loss, lost, None
    root_t = torch.full((1,), root, dtype=torch.int64, device=tr.device)
    st, ad, loss, ok, lost = loop.stage22_step(
        tr.state, tr.adam, tr.kms, tr.bundle, vi, it, tr.bg, rescale, feat, root_t,
        tr.pseudo.cluster_occur[vi, root], rcfg, o, tr.any_alpha)
    return st, ad, None, loss, lost, ok


def step_error(tr, got: tuple, want: tuple, what: str) -> float:
    """The largest normalised difference of two steps' results (the new
    parameters that learn, their Adam moments, the densification statistics
    in stage 0) and their losses; raise past K3_TOL or on a lost slot."""
    (st_g, mu_g, nu_g, sa_g, l_g, lost_g), (st_w, ad_w, sa_w, l_w, lost_w) = got, want
    keys = [k for k in st_w.params() if sa_w is not None or k == "ins_feat"]
    pairs = ([(k, getattr(st_g, k), getattr(st_w, k)) for k in keys]
             + [(f"mu {k}", mu_g[k], ad_w.mu[k]) for k in keys]
             + [(f"nu {k}", nu_g[k], ad_w.nu[k]) for k in keys])
    if sa_w is not None:
        pairs += [(f"stats {f.name}", getattr(sa_g, f.name), getattr(sa_w, f.name))
                  for f in dataclasses.fields(sa_w)]
    worst = abs(float(l_g) - float(l_w)) / max(abs(float(l_w)), 1e-12)
    for name, a, b in pairs:
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name} is not finite")
        worst = max(worst, normalised_err(a, b.cpu()) if bool(b.any()) else float(a.abs().max()))
    if worst > K3_TOL or int(lost_g) != 0 or int(lost_w) != 0:
        raise AssertionError(f"{what}: captured against eager {worst:.3e} (K3's tolerance "
                             f"{K3_TOL}), slots lost {int(lost_g)} / {int(lost_w)}")
    return worst


def check_captured_step(tr, stage: str, vi: int = 0, rescale: float = 1.0,
                        root: int = 1) -> dict:
    """One step of `stage` captured as the trainer's blocks capture it
    (Trainer._captured_step: static buffers, a CUDA graph on the card) and
    replayed once, against the same step run eagerly from the same state, to
    K3's tolerance. -> {"err", "loss", "ok"}."""
    e = eager_step(tr, stage, vi, rescale, root)
    step = tr._captured_step(stage, False, None)
    row = tr._step_row(stage, STEP_ITS[stage], vi, tr._bg_values(stage), rescale, root,
                       tr.adam.count + 1)
    loss = step.run(row.to(tr.device))
    io = step.io
    got = (io["state"], io["mu"], io["nu"], io["stats"], loss, io["lost"])
    err = step_error(tr, got, (e[0], e[1], e[2], e[3], e[4]), f"captured stage-{stage} step")
    return dict(err=err, loss=float(e[3]), ok=None if e[5] is None else bool(e[5]))


def check_sync_free_step(tr, stage: str, rcfg=None) -> None:
    """One eager step of `stage` at the trainer's fixed budgets under
    torch.cuda.set_sync_debug_mode("error"): any host sync raises. A step
    runs first without it, which builds the kernels and fills the caches a
    first step fills (SSIM's band matrices)."""
    eager_step(tr, stage, rcfg=rcfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager_step(tr, stage, rcfg=rcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def check_blob_steps(dev, root: str) -> dict:
    """At 160x120 on the blob trainer, in the stream, dense and compact
    configurations: each stage's eager step at fixed budgets with no host
    sync, and its captured step against the eager one; the stage-2.2 step
    of root 1 has `ok` true and a nonzero loss (ROADMAP Queue 3, check a,
    where the full-width run's roots fail the gates). -> {layout: {stage:
    err}}."""
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig

    out = {}
    for layout, upd in LAYOUTS.items():
        tr = blob_trainer(dev, RasterizeConfig(**upd), os.path.join(root, f"blob_{layout}"))
        errs = {}
        for stage in STAGES:
            check_sync_free_step(tr, stage)
            r = check_captured_step(tr, stage)
            errs[stage] = r["err"]
            if stage == "2.2" and not (r["ok"] and r["loss"] > 0):
                raise AssertionError(f"blob trainer ({layout}): the stage-2.2 step of root 1 "
                                     f"has ok {r['ok']}, loss {r['loss']}")
        log(f"captured steps at 160x120 ({layout}), budgets P={tr.rcfg.intersection_budget} "
            f"K={tr.rcfg.max_per_tile} (groups P={tr.rcfg.group_intersection_budget} "
            f"K={tr.rcfg.group_max_per_tile}): each stage's eager step ran with no host "
            f"sync; captured against eager " + ", ".join(f"{s} {e:.2e}" for s, e in errs.items())
            + " (stage 2.2: root 1, ok true, loss > 0)")
        out[layout] = errs
    return out


def budgets_phase(tr, card: str):
    """Fixed budgets on the stream run's trained state: the probe, the
    tuned frame and group budgets (ops/budget.py against RasterizeConfig()),
    every view's render at them with nothing dropped or truncated, and a
    stage-1 step at them against the same step with the stream sized per
    frame, to K3's tolerance. -> the tuned config."""
    from opengaussian_tpu_torch.ops import budget
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render

    o, V = tr.cfg.opt, tr.bundle.num_views
    cams = [tr.bundle.camera(v) for v in range(V)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total, cnt = budget.probe(tr.state, cams)
    tuned = budget.tuned_config(RasterizeConfig(), tr.state, cams)
    tuned = budget.tuned_group_config(tuned, tr.state, cams, tr.kms.cls_ids, o.root_node_num)
    probe_s = time.perf_counter() - t0
    n = tr.state.capacity
    for v, cam in enumerate(cams):
        with torch.no_grad():
            out = render(cam, tr.state, tr.bg, 3, tuned, render_color=True,
                         render_feat_map=True)
        if int(out.n_lost) != 0:
            raise AssertionError(f"view {v} at the tuned budgets lost {int(out.n_lost)} slots")
    e = eager_step(tr, "1", rcfg=dataclasses.replace(tr.rcfg, intersection_budget=0))
    f = eager_step(tr, "1", rcfg=tuned)
    err = step_error(tr, (f[0], f[1].mu, f[1].nu, None, f[3], f[4]), e[:5],
                     "stage-1 step at fixed budgets")
    log(f"budgets: probe (largest total {total}, deepest tile {cnt}) and tuning "
        f"{probe_s:.3f} s; P = {tuned.max_intersections(n)} ({tuned.max_intersections(n) / n:.2f}"
        f" N against the JAX package's 8 N), K = {tuned.max_per_tile}, group P = "
        f"{tuned.group_intersection_budget}, group K = {tuned.group_max_per_tile}; every view "
        f"renders at them with n_dropped = n_truncated = 0; the stage-1 step at them against "
        f"the stream sized per frame {err:.2e} [{card}]")
    return tuned


def frozen_phase(tr, tuned, card: str) -> dict:
    """Frozen plans on the trained state at the tuned budgets: every view's
    plan (the build time and bytes), a stage-1 and stage-2.1 step through
    the plan against the fresh binning at rescale 1 (K3's tolerance) and
    the feature render through it at rescale 0.55 (within 0.02, at most 3%
    of pixels past 1e-5: the JAX package's bound), and the stage-1 step
    with and without the plan, in turns."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import build_frozen_plan, stack_plans
    from opengaussian_tpu_torch.render import render

    V, n = tr.bundle.num_views, tr.state.capacity
    cov3d = build_cov3d(tr.state.scales, tr.state.quats)
    build = lambda: stack_plans([build_frozen_plan(tr.bundle.camera(v), tr.state.means,  # noqa: E731
                                                   cov3d, tr.state.opacity, tuned)
                                 for v in range(V)], n)
    build_ms = cuda_ms(build, iters=2)
    plans = build()
    lost = int((plans.n_dropped + plans.n_truncated).sum())
    if lost:
        raise AssertionError(f"frozen plans at the tuned budgets lost {lost} slots")
    errs = {}
    for stage in ("1", "2.1"):
        e = eager_step(tr, stage, rcfg=tuned)
        f = eager_step(tr, stage, rcfg=tuned, frozen=plans.select(0))
        errs[stage] = step_error(tr, (f[0], f[1].mu, f[1].nu, None, f[3], f[4]), e[:5],
                                 f"stage-{stage} step through the frozen plan")
    with torch.no_grad():
        kw = dict(render_color=False, render_feat_map=True, rescale_factor=0.55)
        fresh = render(tr.bundle.camera(0), tr.state, tr.bg, 3, tuned, **kw)
        fz = render(tr.bundle.camera(0), tr.state, tr.bg, 3, tuned, frozen=plans.select(0), **kw)
    diff = (fz.ins_feat - fresh.ins_feat).abs()
    dmax, frac = float(diff.max()), float((diff > 1e-5).float().mean())
    if dmax > 0.02 or frac > 0.03:
        raise AssertionError(f"frozen plan at rescale 0.55: max {dmax}, share past 1e-5 {frac}")
    fns = {"fresh": lambda: eager_step(tr, "1", rcfg=tuned),
           "frozen": lambda: eager_step(tr, "1", rcfg=tuned, frozen=plans.select(0))}
    turns = [(k, cuda_ms(fns[k], iters=10)) for k in ("fresh", "frozen", "frozen", "fresh")]
    # the same step captured (the blocks' step), with and without the plans:
    # what the plan saves on the card once the host no longer sets the pace
    saved = (tr.rcfg, tr.autotune_budgets)
    tr.autotune_budgets = True
    tr._set_rcfg(tuned)
    try:
        row = tr._step_row("1", STEP_ITS["1"], 0, tr._bg_values("1"), 1.0, 0,
                           tr.adam.count + 1).to(tr.device)
        steps = {"fresh": tr._captured_step("1", False, None)}
        tr._captured.clear()  # one graph per stage: keep the fresh one aside
        steps["frozen"] = tr._captured_step("1", False, plans)
        steps["fresh"].copy_in(tr)
        cap = [(k, cuda_ms(lambda k=k: steps[k].run(row), iters=10))
               for k in ("fresh", "frozen", "frozen", "fresh")]
        busy = {k: profile(lambda k=k: steps[k].run(row), 3,
                           f"captured stage-1 step ({k} binning)")[0] for k in steps}
    finally:
        tr._set_rcfg(saved[0])
        tr.autotune_budgets = saved[1]
    log(f"frozen plans: {V} views built in {build_ms:.3f} ms, {plans.nbytes() / 2**20:.1f} MiB "
        f"(P = {plans.g_sorted.shape[1]}), lossless; stage-1 / stage-2.1 step through the plan "
        f"against the fresh binning {errs['1']:.2e} / {errs['2.1']:.2e}; the feature render at "
        f"rescale 0.55 within {dmax:.3e}, {frac:.4f} of its values past 1e-5; stage-1 step ms "
        f"in turns, eager " + ", ".join(f"{k} {v:.3f}" for k, v in turns) + "; captured "
        + ", ".join(f"{k} {v:.3f}" for k, v in cap) + f"; captured busy fresh "
        f"{busy['fresh']:.3f}, frozen {busy['frozen']:.3f} [{card}]")
    return dict(build_ms=build_ms, mib=plans.nbytes() / 2**20, turns=turns, cap=cap,
                busy=busy)


def captured_phase(tr, tuned, card: str) -> dict:
    """Captured steps at full width from the trained state, in the stream,
    dense and compact configurations at the tuned budgets: each stage's
    eager step with no host sync, its captured step against it to K3's
    tolerance, then, in turns (eager, captured, captured, eager), the wall
    ms per step (10 steps between CUDA events, each from the same state),
    and torch.profiler's busy time, idle share and kernel launches over one
    step of each (over 3 steps). -> {(layout, stage): {"err", "eager",
    "captured": (ms, busy, idle, launches)}}."""
    out = {}
    saved = (tr.rcfg, tr.autotune_budgets)
    tr.autotune_budgets = True
    try:
        for layout, upd in LAYOUTS.items():
            rcfg = dataclasses.replace(tuned, **upd)
            tr._set_rcfg(rcfg)
            for stage in STAGES:
                check_sync_free_step(tr, stage)
                r = check_captured_step(tr, stage, root=0)
                step = tr._captured_step(stage, False, None)
                row = tr._step_row(stage, STEP_ITS[stage], 0, tr._bg_values(stage), 1.0, 0,
                                   tr.adam.count + 1).to(tr.device)
                fns = {"eager": lambda s=stage: eager_step(tr, s, root=0),
                       "captured": lambda: step.run(row)}
                ms = {k: [] for k in fns}
                for k in ("eager", "captured", "captured", "eager"):
                    ms[k].append(cuda_ms(fns[k], iters=10))
                prof = {}
                for k in fns:
                    counts = {}
                    busy, wall = profile(fns[k], 3, f"{k} stage-{stage} step ({layout})",
                                         counts=counts)
                    prof[k] = (sum(ms[k]) / 2, busy, 1.0 - busy / wall, counts["launches"])
                out[(layout, stage)] = dict(err=r["err"], **prof)
                log(f"captured stage-{stage} step ({layout}): against eager {r['err']:.2e}; "
                    f"ms in turns eager, captured, captured, eager: {ms['eager'][0]:.3f}, "
                    f"{ms['captured'][0]:.3f}, {ms['captured'][1]:.3f}, {ms['eager'][1]:.3f}; "
                    f"profiled busy / idle share / kernels per step: eager "
                    f"{prof['eager'][1]:.3f} / {prof['eager'][2]:.3f} / {prof['eager'][3]}, "
                    f"captured {prof['captured'][1]:.3f} / {prof['captured'][2]:.3f} / "
                    f"{prof['captured'][3]} [{card}]")
    finally:
        tr._set_rcfg(saved[0])
        tr.autotune_budgets = saved[1]
    return out


def blocked_trainer(*args, **kw):
    """cli.train's Trainer with the JAX package's options for fixed shapes
    switched on, as a user sets them: autotune_budgets, use_frozen_plans and
    BLOCK_SIZES = BLOCKS."""
    from opengaussian_tpu_torch.train import loop

    tr = loop.Trainer(*args, autotune_budgets=True, **kw)
    tr.use_frozen_plans = True
    tr.BLOCK_SIZES = BLOCKS
    return tr


def check_blocked_run(tr_b, out_b: str, tr_s, out_s: str, seconds: dict, card: str) -> dict:
    """The blocked run (fixed budgets, frozen plans, captured blocks) against
    the stream run of the same schedule, at the same draws: the same first
    loss, and the losses of the steps before the first densification (1-20)
    to 1e-4; the geometry of the iteration-40 PLYs is logged, not held bit
    for bit: K3's atomic order changes the last bits of every gradient from
    run to run, and a densification threshold then splits or prunes a
    splat in one run and not in the other. No slot lost at the tuned
    budgets, the plans built, and the wall time of each run."""
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply

    l_b, l_s = float(tr_b.losses[0]), float(tr_s.losses[0])
    if not math.isclose(l_b, l_s, rel_tol=1e-5):
        raise AssertionError(f"first loss: blocked run {l_b!r}, stream {l_s!r}")
    first = [np.array([float(x) for x in t.losses[:20]]) for t in (tr_b, tr_s)]
    d20 = float(np.max(np.abs(first[0] - first[1]) / np.abs(first[1])))
    if d20 > 1e-4:
        raise AssertionError(f"blocked run: steps 1-20 differ from the stream run's by {d20}")
    it0 = STAGE_ENDS["start_ins_feat_iter"]
    ply = [load_gaussian_ply(os.path.join(d, "point_cloud", f"iteration_{it0}",
                                          "point_cloud.ply")) for d in (out_b, out_s)]
    same = len(ply[0]["means"]) == len(ply[1]["means"])
    geo = {k: (float(np.abs(ply[0][k] - ply[1][k]).max()) if same else float("nan"))
           for k in ("means", "log_scales", "logit_opacity")}
    bitwise = same and all(np.array_equal(ply[0][k], ply[1][k]) for k in geo)
    from opengaussian_tpu_torch.ops.rasterize import FrozenPlan

    if int(tr_b._last_lost) != 0 or not isinstance(tr_b._frozen_plans, FrozenPlan):
        raise AssertionError(f"blocked run: lost {int(tr_b._last_lost)} slots, plans "
                             f"{tr_b._frozen_plans!r}")
    n = tr_b.state.capacity
    log(f"blocked run: first loss {l_b:.7f} (stream {l_s:.7f}), steps 1-20 within {d20:.2e}; "
        f"at iteration {it0} "
        f"{len(ply[0]['means'])} splats (stream {len(ply[1]['means'])}), geometry bit for "
        f"bit {bitwise}, largest differences " + ", ".join(f"{k} {v:.3e}" for k, v in geo.items())
        + f"; budgets P = {tr_b.rcfg.max_intersections(n)}, K = {tr_b.rcfg.max_per_tile}, "
        f"groups P = {tr_b.rcfg.group_intersection_budget}, K = {tr_b.rcfg.group_max_per_tile}"
        f"; the run {seconds['blocked']:.2f} s against the stream run's "
        f"{seconds['stream']:.2f} s (each with its setup, sweeps, stage 3 and saves) [{card}]")
    return dict(bitwise=bitwise, geo=geo)


def group_block(tr, K: int, G: int):
    """The training frame's dense block (view 0's feature pass, C = 7, at
    max_per_tile K) with its splat ids and the alive opacities of roots
    0..G-1 as a [G, N] table. -> (gdata, gauss_idx, opac_g, counts,
    tile_start, P, grid_x)."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _prepare, gather_rows
    from opengaussian_tpu_torch.render import encoded_ins_feat

    st, cam = tr.state, tr.bundle.camera(0)
    cfg = RasterizeConfig(max_per_tile=K, pallas_input="dense")
    with torch.no_grad():
        proj, bins, (gx, _) = _prepare(cam, st.means, build_cov3d(st.scales, st.quats),
                                       st.opacity, cfg)
        payload = torch.cat([encoded_ins_feat(st, origin_feat=True), proj.depth[:, None]], -1)
        gdata = gather_rows(proj.mean2d, proj.conic, torch.zeros_like(st.opacity), payload,
                            bins.gauss_idx)
        opac = torch.where(proj.valid & st.alive, st.opacity, 0.0)
        gids = torch.arange(G, device=st.device)
        opac_g = torch.where(tr.kms.cls_ids[None, :] == gids[:, None], opac[None, :], 0.0)
    return (gdata, bins.gauss_idx, opac_g.contiguous(), bins.counts, bins.tile_start,
            bins.sorted_gauss.shape[0], gx)


def dense_groups_phase(tr, tr_b, chunk: int, card: str) -> dict:
    """group_render="dense" at full width. The group entries of K5 and K6
    on the training frame's block at G = 1 and G = 5 (roots 0-4) against
    their plain versions, bit for bit, and their times; rasterize_groups
    against rasterize_scan_groups over roots 0-4; then the path a user of
    the option runs, its launches counted: sweep 2 and stage 3 of view 0
    (stage 3 in the dense layout, which renders each root's leaves as
    groups) and 5 stage-2.2 steps of the blocked trainer, one captured
    block; and sweep 2 and stage 3 per view beside the stream numbers.
    -> {"errs", "launches", "leaf_ms"}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import rasterize_groups, rasterize_scan_groups
    from opengaussian_tpu_torch.render import encoded_ins_feat
    from opengaussian_tpu_torch.train import lang
    from opengaussian_tpu_torch.train import pseudo as pseudo_mod

    K = tr.rcfg.max_per_tile
    errs = {}
    for G in (1, 5):
        gdata, gidx, opac_g, counts, tstart, P, gx = group_block(tr, K, G)
        fargs = (gdata, gidx, opac_g, counts, gx, chunk)
        acc, tf = rk.blend_tiles_fwd_groups(*fargs)
        torch.cuda.synchronize()
        acc_p, tf_p = rk.blend_tiles_fwd_groups_plain(*fargs)
        e = max(compare(f"blend_tiles_fwd_groups G={G} training frame {nm}", x, y, 0.0, 0.0)
                for nm, x, y in (("accum", acc, acc_p), ("t_final", tf, tf_p)))
        gen = torch.Generator(device=gdata.device).manual_seed(G)
        cot = [torch.randn(x.shape, generator=gen, device=x.device) * 0.1 for x in (acc, tf)]
        bargs = (gdata, gidx, opac_g, counts, tstart, P, acc, tf, *cot, gx, chunk)
        d = rk.blend_tiles_bwd_groups(*bargs)
        torch.cuda.synchronize()
        d_p = rk.blend_tiles_bwd_groups_plain(*bargs)
        e = max(e, compare(f"blend_tiles_bwd_groups G={G} training frame d_rows", d, d_p,
                           0.0, 0.0))
        if float(d_p.abs().max()) == 0.0:
            raise AssertionError(f"blend_tiles_bwd_groups G={G}: no gradient")
        errs[G] = e
        fwd_dev = device_ms(lambda: rk.blend_tiles_fwd_groups(*fargs), 5,
                            "blend_tiles_fwd_groups_kernel")
        bwd_dev = device_ms(lambda: rk.blend_tiles_bwd_groups(*bargs), 5,
                            "blend_tiles_bwd_groups_kernel")
        k5 = device_ms(lambda: rk.blend_tiles_fwd(gdata, counts, gx, chunk), 5,
                       "blend_tiles_fwd_kernel")
        log(f"timing: group entries G={G} on the training frame's block {list(gdata.shape)}: "
            f"forward kernel {fwd_dev:.4f} ms, backward kernel {bwd_dev:.4f} ms (K5 on the "
            f"block's own opacities {k5:.4f} ms), bit for bit with their plain versions "
            f"[{card}]")
    # the dense group render against the scan of per-group renders, roots 0-4
    st, cam = tr.state, tr.bundle.camera(0)
    cov3d = build_cov3d(st.scales, st.quats)
    gids = torch.arange(5, device=st.device)
    opac_g = torch.where((tr.kms.cls_ids[None, :] == gids[:, None]) & st.alive[None, :],
                         st.opacity[None, :], 0.0)
    payload = encoded_ins_feat(st, origin_feat=True)
    bg6 = torch.cat([tr.bg, tr.bg])
    with torch.no_grad():
        a = rasterize_groups(cam, st.means, cov3d, opac_g, payload, bg6, tr.rcfg)
        b = rasterize_scan_groups(cam, st.means, cov3d, opac_g, payload, bg6, tr.rcfg)
    g_err = max(compare(f"rasterize_groups against rasterize_scan_groups {k}",
                        getattr(a, k), getattr(b, k), TOL["atol"], TOL["rtol"])
                for k in ("image", "alpha"))
    # the path a user of the option runs, its launches counted
    o, bdl = tr_b.cfg.opt, tr_b.bundle
    k1, k2 = o.root_node_num, o.leaf_node_num
    dense = dataclasses.replace(tr_b.rcfg, group_render="dense")
    wrappers = zero_launches()
    pseudo_mod._sweep2_view(tr_b.state, bdl.camera(0), tr_b.pseudo.feat[0],
                            tr_b.pseudo.mask_ids[0], tr_b.kms.cls_ids, tr_b.bg, bdl.max_masks,
                            k1, dense)
    lang._associate_view(tr_b.state, tr_b.kms.leaf_cls_ids, bdl.camera(0), tr_b.pseudo.feat[0],
                         tr_b.pseudo.mask_ids[0], tr_b.pseudo.cluster_occur[0], tr_b.bg, k1,
                         k2, bdl.max_masks, dataclasses.replace(dense, pallas_input="dense"))
    tr_b.rcfg = dense
    it0 = tr_b.iteration
    tr_b.train(until=it0 + 5, log_every=200)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = dict.fromkeys(launches, 0)
    want.update(blend_tiles_fwd_groups=1 + k1 + 5, blend_tiles_bwd_groups=5,
                segment_reduce=5, blend_stream_fwd=5 if tr_b.any_alpha else 0)
    if launches != want:
        raise AssertionError(f"dense group path: launches {launches}, expected {want}")
    losses = [float(x) for x in tr_b.losses[-5:]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dense group steps: losses {losses}")
    log(f"dense group path: sweep 2 and stage 3 of view 0 and stage-2.2 steps {it0 + 1}-"
        f"{it0 + 5} (one captured block, losses {losses}), launches {launches}; "
        f"rasterize_groups against rasterize_scan_groups (roots 0-4) {g_err:.3e}")
    saved = tr.rcfg
    tr.rcfg = dataclasses.replace(saved, pallas_input="dense", group_render="dense")
    try:
        leaf_ms = time_leaf_events(tr, card, "dense groups")
    finally:
        tr.rcfg = saved
    return dict(errs=errs, launches=launches, leaf_ms=leaf_ms, group_err=g_err)


def time_on_frame(name: str, kernel: str, full, alone, bound: float, by: str,
                  card: str) -> dict:
    """Call and device time of one kernel on the training frame, whole and
    with only its deepest tile, beside its bound.
    -> {"ms", "dev", "deep_ms", "deep_dev"}."""
    out = dict(ms=cuda_ms(full, iters=10, warmup=2), dev=device_ms(full, 10, kernel),
               deep_ms=cuda_ms(alone, iters=20, warmup=2), deep_dev=device_ms(alone, 20, kernel))
    log(f"timing: {name} C=7 training frame: call {out['ms']:.4f} ms, kernel "
        f"{out['dev']:.4f} ms; the deepest tile alone: call {out['deep_ms']:.4f} ms, "
        f"kernel {out['deep_dev']:.4f} ms [{card}]")
    log(f"bound: {name} C=7 training frame: {bound:.4f} ms/launch ({by}), kernel "
        f"(device time) at {bound / out['dev']:.3f} of it [{card}]")
    return out


def time_against_parent(prk, cases: dict, card: str) -> dict:
    """Each case's kernel beside the parent tree's, in turns (this tree's,
    the parent's, the parent's, this tree's): the call by CUDA events over 20
    launches, the kernel by torch.profiler's device time over 10. prk: the
    parent tree's rasterize_kernels module; cases: {label: (kernel name,
    this tree's call, the parent's call)}. -> {label: {"ms", "parent_ms",
    "dev", "parent_dev"}}."""
    out = {}
    for label, (kname, new, old) in cases.items():
        calls = [cuda_ms(f, iters=20, warmup=3) for f in (new, old, old, new)]
        devs = [device_ms(f, 10, kname) for f in (new, old, old, new)]
        r = dict(ms=(calls[0] + calls[3]) / 2, parent_ms=(calls[1] + calls[2]) / 2,
                 dev=(devs[0] + devs[3]) / 2, parent_dev=(devs[1] + devs[2]) / 2)
        log(f"timing: {label}, this tree against the parent tree's kernel in turns "
            f"(this, parent, parent, this): call " + ", ".join(f"{x:.4f}" for x in calls)
            + " ms; kernel " + ", ".join(f"{x:.4f}" for x in devs) + f" ms; this tree's "
            f"kernel at {r['dev'] / r['parent_dev']:.3f} of the parent's, its call at "
            f"{r['ms'] / r['parent_ms']:.3f} [{card}]")
        out[label] = r
    return out


def load_parent_kernels(path: str):
    """The rasterize_kernels module of another checkout of this repository
    (the parent commit), with its own csrc/ and build, to time its kernels
    beside this tree's on the same inputs. Its plain-torch imports resolve
    to this tree's package, which the kernels do not read."""
    import importlib.util

    src = os.path.join(path, "opengaussian_tpu_torch", "ops", "rasterize_kernels.py")
    spec = importlib.util.spec_from_file_location("parent_rasterize_kernels", src)
    prk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prk)
    t0 = time.perf_counter()
    _, build_log = prk.build()
    log(f"parent tree: {path}: built its kernels in {time.perf_counter() - t0:.3f} s")
    for line in build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"parent tree: {path}: build: {line.strip()}")
    return prk


def parent_k6(prk, gdata, counts, tstart, n_rows: int, *rest):
    """A call of another tree's K6 on these inputs: the parent's takes no
    stream positions and returns the whole [T, K, F] block."""
    import inspect

    if "tstart" in inspect.signature(prk.blend_tiles_bwd).parameters:
        return lambda: prk.blend_tiles_bwd(gdata, counts, tstart, n_rows, *rest)
    return lambda: prk.blend_tiles_bwd(gdata, counts, *rest)


def time_train_frame(tr, chunk: int, card: str, peak_flops, peak_bytes,
                     prks: dict | None = None) -> dict:
    """K1, K2, K4 and K6 on the training frame: the feature pass (C = 7) of
    view 0 of the profiled stage-1 step, from the trained state at the
    trainer's fitted max_per_tile, the backwards with the stage-1 loss's
    cotangents, K6 on the same frame's dense block. Holds each against its
    plain version bit for bit (K4 on the tiles' range, its ids everywhere)
    and K6's rows against K2's, counts the frame's pairs, and times each
    (call and device time) beside its bound and the deepest tile alone
    (every other tile's count set to 0), which sets the launch's least
    time. With prks ({path: another tree's kernels}, the parent's), also
    K2, K4 and K6 in turns with each. -> {"k1": {"err", "ms", "dev",
    "deep_ms", "deep_dev", "bound", "by"}, "k2", "k4", "k6": the same}."""
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    cam = tr.bundle.camera(0)
    with torch.no_grad():
        rows, counts, tstart, toff, gx, bins, _ = frame_streams(cam, tr.state, tr.rcfg)[7]
        fwd_args = (rows, counts, tstart, toff, gx, chunk)
        acc, t_final = rk.blend_stream_fwd(*fwd_args)
        torch.cuda.synchronize()
        acc_p, t_p, work_f = rk.blend_stream_fwd_plain(*fwd_args, count_work=True)
    k1_err = max(compare(f"blend_stream_fwd C=7 training frame {nm}", x, y, 0.0, 0.0)
                 for nm, x, y in (("accum", acc, acc_p), ("t_final", t_final, t_p)))
    cot = stage1_cotangents(cam, (gx, (HEIGHT + 15) // 16), acc, t_final,
                            tr.bundle.sam_ids[0], tr.bundle.max_masks,
                            tr.cfg.opt.loss_weight)
    args = (rows, counts, tstart, toff, acc, t_final, *cot, gx, chunk)
    d = rk.blend_stream_bwd(*args)
    torch.cuda.synchronize()
    d_p, work = rk.blend_stream_bwd_plain(*args, count_work=True)
    err = compare("blend_stream_bwd C=7 training frame d_rows", d, d_p, 0.0, 0.0)
    if float(d_p.abs().max()) == 0.0:
        raise AssertionError("K2, training frame: the stage-1 loss gave no gradient")
    deep = int(torch.argmax(counts))
    depth = int(counts[deep])
    only = torch.where(torch.arange(counts.shape[0], device=counts.device) == deep, counts, 0)
    d_only = rk.blend_stream_bwd(rows, only, *args[2:])
    run = slice(int(tstart[deep]), int(tstart[deep]) + depth)
    if not torch.equal(d_only[run], d[run]) or bool(d_only[:run.start].any()) or \
            bool(d_only[run.stop:].any()):
        raise AssertionError("K2: the deepest tile alone differs from its rows in the frame")
    with torch.no_grad():
        acc_o, t_o = rk.blend_stream_fwd(rows, only, *fwd_args[2:])
    if not (torch.equal(acc_o[deep], acc[deep]) and torch.equal(t_o[deep], t_final[deep])):
        raise AssertionError("K1: the deepest tile alone differs from its block in the frame")
    log(f"K1 and K2, training frame (stage-1 feature pass, view 0, C=7): {int(counts.sum())} "
        f"slots in {counts.shape[0]} tiles, deepest tile {depth} slots ({-(-depth // chunk)} "
        f"chunks), max_per_tile {tr.rcfg.max_per_tile}; "
        "work K1 " + ", ".join(f"{k} {v}" for k, v in work_f.items())
        + "; work K2 " + ", ".join(f"{k} {v}" for k, v in work.items())
        + "; the deepest tile alone gives its outputs in the frame bit for bit")
    # K4 on the same stream and cotangents
    n = tr.state.capacity
    cargs = (rows, counts, tstart, toff, bins.sorted_gauss, acc, t_final, *cot, gx, chunk, n)
    d4, ids4 = rk.blend_stream_bwd_compact(*cargs)
    torch.cuda.synchronize()
    d4_p, ids4_p = rk.blend_stream_bwd_compact_plain(*cargs)
    nc_rows = rk.compact_offsets(counts, chunk)[1] * chunk
    k4_err = compare("blend_stream_bwd_compact C=7 training frame d_rows", d4[:nc_rows],
                     d4_p[:nc_rows], 0.0, 0.0)
    if not torch.equal(ids4, ids4_p):
        raise AssertionError("K4, training frame: the ids differ from the plain version's")
    del d4, ids4, d4_p, ids4_p
    # K6 on the frame's dense block, gathered from the same stream
    with torch.no_grad():
        gdata, dcounts, dstart, gauss, _, n_trunc = frame_dense(cam, tr.state,
                                                               tr.rcfg.max_per_tile)
        if n_trunc or not (torch.equal(dcounts, counts) and torch.equal(dstart, tstart)):
            raise AssertionError("the training frame's dense block is not its stream's")
        acc5, t5 = rk.blend_tiles_fwd(gdata, dcounts, gx, chunk)
    if not (torch.equal(acc5, acc) and torch.equal(t5, t_final)):
        raise AssertionError("K5 on the training frame's block differs from K1")
    P = rows.shape[0]
    bargs = (gdata, dcounts, dstart, P, acc, t_final, *cot, gx, chunk)
    d6 = rk.blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    k6_err = compare("blend_tiles_bwd C=7 training frame d_rows", d6,
                     rk.blend_tiles_bwd_plain(*bargs), 0.0, 0.0)
    if not torch.equal(d6, d):
        raise AssertionError("K6, training frame: its rows differ from K2's")
    del d6
    log(f"K4 and K6, training frame: K4 bit for bit on its {nc_rows} rows of the tiles' "
        f"range (of {rk.compact_rows(P, counts.shape[0], chunk)}); K6 on the block "
        f"{list(gdata.shape)} ({gdata.numel() * 4 / 1e9:.3f} GB) bit for bit with its "
        f"plain version and with K2's rows, [{P}, {rows.shape[1]}]")
    live, F, T = int(counts.sum()), rows.shape[1], counts.shape[0]
    out = {}
    with torch.no_grad():
        bound, by = fwd_bound("blend_stream_fwd C=7 training frame", live, F, T, 3, work_f,
                              peak_flops, peak_bytes)
        out["k1"] = dict(err=k1_err, bound=bound, by=by, **time_on_frame(
            "blend_stream_fwd", "blend_stream_fwd_kernel", lambda: rk.blend_stream_fwd(*fwd_args),
            lambda: rk.blend_stream_fwd(rows, only, *fwd_args[2:]), bound, by, card))
    bound, by = bwd_bound("blend_stream_bwd C=7 training frame", live, F, T, 3, work,
                          peak_flops, peak_bytes)
    out["k2"] = dict(err=err, bound=bound, by=by, **time_on_frame(
        "blend_stream_bwd", "blend_stream_bwd_kernel", lambda: rk.blend_stream_bwd(*args),
        lambda: rk.blend_stream_bwd(rows, only, *args[2:]), bound, by, card))
    R = rk.compact_rows(P, T, chunk)
    bound, by = compact_bound(live, nc_rows, R, F, T, work, peak_flops, peak_bytes)
    out["k4"] = dict(err=k4_err, bound=bound, by=by, **time_on_frame(
        "blend_stream_bwd_compact", "blend_stream_bwd_compact_kernel",
        lambda: rk.blend_stream_bwd_compact(*cargs),
        lambda: rk.blend_stream_bwd_compact(rows, only, *cargs[2:]), bound, by, card))
    bound, by = bwd_bound("blend_tiles_bwd C=7 training frame", live, F, T, 2, work,
                          peak_flops, peak_bytes)
    out["k6"] = dict(err=k6_err, bound=bound, by=by, **time_on_frame(
        "blend_tiles_bwd", "blend_tiles_bwd_kernel", lambda: rk.blend_tiles_bwd(*bargs),
        lambda: rk.blend_tiles_bwd(gdata, only, *bargs[2:]), bound, by, card))
    for path, prk in (prks or {}).items():
        log(f"parent tree {path}, training frame:")
        time_against_parent(prk, {
            "blend_stream_bwd C=7 training frame": (
                "blend_stream_bwd_kernel", lambda: rk.blend_stream_bwd(*args),
                lambda: prk.blend_stream_bwd(*args)),
            "blend_stream_bwd_compact C=7 training frame": (
                "blend_stream_bwd_compact_kernel", lambda: rk.blend_stream_bwd_compact(*cargs),
                lambda: prk.blend_stream_bwd_compact(*cargs)),
            "blend_tiles_bwd C=7 training frame": (
                "blend_tiles_bwd_kernel", lambda: rk.blend_tiles_bwd(*bargs),
                parent_k6(prk, *bargs))}, card)
    return out


def compact_bound(live: int, nc_rows: int, rows: int, F: int, T: int, work, peak_flops,
                  peak_bytes) -> tuple[float, str]:
    """K4: the live rows and their splat ids read once, the rows of the
    tiles' range written once (nc_rows), every id of the output written once
    (rows), the [T] counts, tstart, toff and cstart tables,
    accum/g_accum/t_final/g_t read once; the replay's operations from its
    pair counts, as K2's."""
    C = F - 6
    moved = (live * (F + 1) * 4 + nc_rows * F * 4 + rows * 4 + 4 * T * 4
             + 2 * T * 256 * (C + 1) * 4)
    ops = walk_ops(work) + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1)
    return bound_of("blend_stream_bwd_compact", moved, ops, peak_flops, peak_bytes)


QUERY_TEXTS = ("chip object", "second chip object")


def zero_launches() -> dict:
    """Set every kernel's launch count to 0. -> the wrappers by name."""
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict, want_fwd: int, what: str, **want) -> dict:
    """The counts since zero_launches; raise unless K1 launched want_fwd
    times and every other kernel as `want` says (0 where unnamed)."""
    torch.cuda.synchronize()
    got = {k: w.launches for k, w in wrappers.items()}
    expect = {k: want.get(k, 0) for k in got}
    expect["blend_stream_fwd"] = want_fwd
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect}")
    return got


def substitute_lang_table(model: str, dev) -> tuple[str, dict]:
    """The substitution of tests/test_user_journey.py:72-88: rewrite
    cluster_lang.npz with a converged-quality table (score 0.9, occurrence
    10, a one-hot feature per target) aimed at the two leaves that own the
    most alive splats passing the leaf-level scale cull, since the
    80-iteration run's table has no leaf a text query could find (ROADMAP
    Queue 3, open check a), and write the matching text features as a .zip.
    -> (the .zip's path, {text: target leaf})."""
    import zipfile

    from opengaussian_tpu_torch.models.loading import load_cluster_lang, load_model
    from opengaussian_tpu_torch.render import passes_scale_cull

    state, kms, _ = load_model(model, device=dev)
    lang = load_cluster_lang(model)
    k = lang["leaf_feat"].shape[0]
    alive = state.alive.cpu().numpy()
    small = passes_scale_cull(state).cpu().numpy()
    counts = np.bincount(kms.leaf_cls_ids.cpu().numpy()[alive & small], minlength=k + 1)[:k]
    targets = [int(x) for x in np.argsort(-counts, kind="stable")[:len(QUERY_TEXTS)]]
    log(f"queries: {int(alive.sum())} alive splats, {int((alive & small).sum())} pass the "
        f"leaf-level scale cull, {int((counts > 0).sum())} of {k} leaves own some of them; "
        f"targets: leaves {targets} with {[int(counts[t]) for t in targets]} splats")
    if k > 512 or counts[targets[-1]] < 10:
        raise AssertionError(f"queries: no two leaves of {k} own 10 splats under the cull")
    feat = np.zeros((k, 512), np.float32)
    for t in targets:
        feat[t, t] = 1.0
    np.savez(os.path.join(model, "cluster_lang.npz"), leaf_feat=feat,
             leaf_score=np.full(k, 0.9, np.float32), occu_count=np.full(k, 10.0, np.float32),
             leaf_ind=lang["leaf_ind"])
    path = os.path.join(model, "text_features.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("text_features.json", json.dumps(
            {text: feat[t].tolist() for text, t in zip(QUERY_TEXTS, targets)}))
    return path, dict(zip(QUERY_TEXTS, targets))


def text_query(model: str, scene_dir: str, tf_zip: str, targets: dict, dev, card) -> dict:
    """cli.render_by_text.main over every view for each text: the best leaf
    is the target, the selection is non-empty after the KNN mask and the
    scale cull, an RGB and a silhouette PNG per (text, view), the RGB tinted
    on its white background, one K1 launch per (text, view). K1's output on
    the first (text, frame), captured on its way back to the rasterizer, is
    held bit for bit against its plain version on the same rows."""
    from unittest import mock

    from PIL import Image

    from opengaussian_tpu_torch.cli import render_by_text as cli_text
    from opengaussian_tpu_torch.ops import rasterize as rz
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk

    first = {}

    def capture(*args, **kw):
        out = rk.blend_stream_fwd(*args, **kw)
        if not first:
            first.update(args=args, kw=kw, out=out)
        return out

    wrappers = zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(rz, "blend_stream_fwd", capture):
        recs = cli_text.main(["-m", model, "-s", scene_dir, "--scene_name", "chip_smoke",
                              "--text_features", tf_zip, "--texts", *targets], device=dev)
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers, len(targets) * N_VIEWS, "text query")
    rows, counts = first["args"][:2]
    with torch.no_grad():
        want = rk.blend_stream_fwd_plain(*first["args"], **first["kw"])
    for nm, x, y in zip(("accum", "t_final"), first["out"], want):
        compare(f"blend_stream_fwd C={rows.shape[1] - 6} text query frame {nm}", x, y, 0.0, 0.0)
        if not torch.equal(x, y):
            raise AssertionError(f"K1 on the text query's frame: {nm} differs from the plain "
                                 "version's")
    log(f"queries: K1 on the first (text, frame) at {WIDTH}x{HEIGHT}: {int(counts.sum())} "
        f"slots in {counts.shape[0]} tiles, bit for bit with its plain version")
    base = os.path.join(model, "text2obj", f"ours_{TRAIN_ITERS}")
    for rec in recs:
        text = rec["text"]
        if rec["leaves"][0] != targets[text] or len(rec["frames"]) != N_VIEWS \
                or not rec["after_cull"] > 0:
            raise AssertionError(f"text query {text!r}: {rec}")
        names = [f"{f}_{text}.png" for f in rec["frames"]]
        for sub in ("renders_cluster", "renders_cluster_silhouette"):
            if not all(os.path.exists(os.path.join(base, sub, n)) for n in names):
                raise AssertionError(f"text query {text!r}: missing PNGs in {sub}")
        low = min(int(np.asarray(Image.open(os.path.join(base, "renders_cluster", n))).min())
                  for n in names)
        if not low < 250:
            raise AssertionError(f"text query {text!r}: the selection rendered nothing")
        log(f"queries: text {text!r} -> leaves {rec['leaves']}: {rec['members']} splats, "
            f"{rec['after_knn']} after the KNN mask, {rec['after_cull']} under the scale "
            f"cull; darkest pixel {low}; per (text, frame): host selection "
            f"{1e3 * rec['select_s'] / N_VIEWS:.3f} ms, KNN {1e3 * rec['knn_s'] / N_VIEWS:.3f} "
            f"ms, render to PNG " + ", ".join(f"{1e3 * s:.3f}" for s in rec["render_s"])
            + f" ms [{card}]")
    log(f"queries: text query of {len(targets)} texts x {N_VIEWS} views in {seconds:.2f} s "
        f"(model and scene load included), launches {launches}")
    return dict(recs=recs, launches=launches, seconds=seconds)


def click_pixels(model: str) -> dict:
    """Two clicks on view 0's feature maps, decoded and matched to their
    roots by cli.render_by_click's own helpers: the brightest ins_feat1
    pixel (tests/test_user_journey.py's click; on the 80-iteration model it
    may land in a root with no clustered leaf, which is logged), and the
    brightest pixel whose feature lies nearest a root whose leaves the leaf
    k-means clustered (the 80-iteration run clusters only the root stage 2.2
    enters with). Raises when no pixel of view 0 falls in such a root.
    -> {name: (x, y)}."""
    from opengaussian_tpu_torch.cli.render_by_click import (
        decode_features,
        leaf_slots,
        nearest_roots,
    )
    from opengaussian_tpu_torch.utils.codebook import load_codebook

    fdir = os.path.join(model, "train", "ours")
    feat = decode_features(os.path.join(fdir, "ins_feat1", "00000.png"),
                           os.path.join(fdir, "ins_feat2", "00000.png"))
    pc = os.path.join(model, "point_cloud", f"iteration_{TRAIN_ITERS}")
    roots, _ = load_codebook(os.path.join(pc, "root_code_book"))
    leaves, _ = load_codebook(os.path.join(pc, "leaf_code_book"))
    k1 = roots.shape[0]
    k2 = leaf_slots(leaves.shape[0], k1)
    clustered = np.flatnonzero(np.abs(leaves[:k1 * k2].reshape(k1, k2, -1)).sum((1, 2)) > 0)
    inside = np.isin(nearest_roots(feat.reshape(-1, 6), roots), clustered)
    bright = feat[..., :3].sum(-1).reshape(-1)
    log(f"queries: roots with clustered leaves {clustered.tolist()}; {int(inside.sum())} of "
        f"{inside.size} pixels of view 0 decode into them")
    if not inside.any():
        raise AssertionError("queries: no pixel of view 0 decodes into a root with clustered "
                             "leaves, so no click can select a non-empty leaf")
    W = feat.shape[1]
    pick = {"brightest": int(np.argmax(bright)),
            "in a clustered root": int(np.argmax(np.where(inside, bright, -np.inf)))}
    return {k: (i % W, i // W) for k, i in pick.items()}


def click_query(model: str, scene_dir: str, xy, dev, card, what: str,
                must_render: bool) -> dict:
    """cli.render_by_click.main at pixel xy of view 0: a leaf, one PNG and
    one K1 launch per view; with must_render, splats selected after the KNN
    mask and the scale cull, and a PNG tinted on its white background."""
    from PIL import Image

    from opengaussian_tpu_torch.cli import render_by_click as cli_click

    wrappers = zero_launches()
    rec = cli_click.main(["-m", model, "-s", scene_dir, "--view", "00000", "--click",
                          str(xy[0]), str(xy[1])], device=dev)
    launches = read_launches(wrappers, N_VIEWS, f"click query ({what})")
    names = [f"{f}_leaf{rec['leaf']}.png" for f in rec["frames"]]
    if len(names) != N_VIEWS or not all(os.path.exists(os.path.join(rec["out_dir"], n))
                                        for n in names):
        raise AssertionError(f"click query ({what}): {rec}")
    low = min(int(np.asarray(Image.open(os.path.join(rec["out_dir"], n))).min())
              for n in names)
    if must_render and not (rec["after_cull"] > 0 and low < 250):
        raise AssertionError(f"click query ({what}): the selection rendered nothing "
                             f"(darkest pixel {low}): {rec}")
    log(f"queries: click ({what}) at {xy} -> leaf {rec['leaf']}: {rec['members']} splats, "
        f"{rec['after_knn']} after the KNN mask, {rec['after_cull']} under the scale cull; "
        f"darkest pixel {low}; per view, render to PNG "
        + ", ".join(f"{1e3 * s:.3f}" for s in rec["render_s"]) + f" ms [{card}]")
    return dict(rec, launches=launches)


def check_queries_against_cpu(dev) -> dict:
    """At 160x120 on blob_scene, the card against the CPU: render_selection
    (RGB and feature payloads, the scale cull on; one K1 launch each),
    LPIPS on random weights with cuDNN's TF32 at torch's default (allowed),
    and evaluate_dirs' PSNR and SSIM; each within a normalised 1e-3.
    -> the largest errors."""
    import contextlib
    from unittest import mock

    from PIL import Image

    from opengaussian_tpu_torch.eval import lpips as lp
    from opengaussian_tpu_torch.eval.metrics import evaluate_dirs
    from opengaussian_tpu_torch.render import render_selection

    W, H = 160, 120
    st, roots, cam, _ = blob_scene(W, H)
    st_g = to_device(st, dev)
    rng = np.random.default_rng(17)
    select = (roots == 0) | torch.as_tensor(rng.random(roots.shape[0]) < 0.2)
    errs = {}
    with torch.no_grad():
        for payload_rgb in (True, False):
            wrappers = zero_launches()
            got = render_selection(cam, st_g, torch.ones(3, device=dev), select.to(dev),
                                   payload_rgb=payload_rgb)
            read_launches(wrappers, 1, "render_selection")
            want = render_selection(cam, st, torch.ones(3), select, payload_rgb=payload_rgb)
            for k in ("cluster_imgs", "cluster_silhouettes"):
                errs[f"render_selection {'rgb' if payload_rgb else 'feature'} {k}"] = \
                    normalised_err(getattr(got, k), getattr(want, k))
            for k in ("cluster_occur", "cluster_valid"):
                if bool(getattr(got, k)) != bool(getattr(want, k)):
                    raise AssertionError(f"render_selection on the card: {k} differs")
            if not float(want.cluster_silhouettes.max()) > 0.5:
                raise AssertionError("render_selection: the blob selection rendered nothing")
            if payload_rgb:
                a = want.cluster_imgs.clamp(0, 1).numpy()
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    w = lp.random_weights(seed=3)
    want_lp = lp.LPIPS(w, "cpu")(a, b)
    torch.backends.cudnn.allow_tf32 = True  # torch's default: the call must pin fp32
    try:
        got_lp = lp.LPIPS(w, dev)(a, b)
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("LPIPS did not restore the caller's TF32 setting")
        # what the same network gives with TF32 left on, for the log
        x, y = (torch.as_tensor(v, device=dev).permute(2, 0, 1)[None] for v in (a, b))
        with mock.patch.object(lp, "fp32_convolutions", contextlib.nullcontext), \
                torch.no_grad():
            tf32_lp = float(lp.lpips_pair(x, y, lp.torch_weights(w, dev))[0])
    finally:
        torch.backends.cudnn.allow_tf32 = False
    errs["lpips"] = abs(got_lp - want_lp) / abs(want_lp)
    log(f"queries: LPIPS {W}x{H}, random weights: card {got_lp!r}, cpu {want_lp!r}; with "
        f"TF32 left on the same network gives {tf32_lp!r} (relative error "
        f"{abs(tf32_lp - want_lp) / abs(want_lp):.3e})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as d:
        for sub in ("renders", "gt"):
            os.makedirs(os.path.join(d, sub))
        for i in range(3):
            gt = (np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1) * 255).astype(np.uint8)
            rd = (np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1) * 255).astype(np.uint8)
            Image.fromarray(gt).save(os.path.join(d, "gt", f"{i:05d}.png"))
            Image.fromarray(rd).save(os.path.join(d, "renders", f"{i:05d}.png"))
        args = (os.path.join(d, "renders"), os.path.join(d, "gt"))
        got_m, want_m = evaluate_dirs(*args, device=dev), evaluate_dirs(*args, device="cpu")
    for m in ("PSNR", "SSIM"):
        errs[f"evaluate_dirs {m}"] = max(abs(got_m["per_view"][m][n] - v) / abs(v)
                                         for n, v in want_m["per_view"][m].items())
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    log("queries: card against CPU at 160x120: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))
    if bad:
        raise AssertionError(f"queries: card against CPU past a normalised 1e-3: {bad}")
    return errs


def sibr_request(w2c, width: int, height: int, fovx: float, fovy: float) -> bytes:
    """A SIBR remote-viewer request for one frame that lets training go on
    (the transposed w2c with columns 1 and 2 negated, network_gui.py)."""
    m = np.asarray(w2c, np.float32).T.copy()
    m[:, 1:3] = -m[:, 1:3]
    msg = dict(resolution_x=width, resolution_y=height, train=True, fov_y=fovy, fov_x=fovx,
               z_near=0.01, z_far=100.0, shs_python=False, rot_scale_python=False,
               keep_alive=False, scaling_modifier=1.0,
               view_matrix=[float(x) for x in m.reshape(-1)],
               view_projection_matrix=[0.0] * 16)
    data = json.dumps(msg).encode("utf-8")
    return len(data).to_bytes(4, "little") + data


def recv_exact(sock, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("the viewer server closed early")
        out += chunk
    return out


def viewer_round_trip(scene_dir: str, root: str, dev, card) -> dict:
    """A Trainer on the card at full width takes stage-0 steps with the
    viewer on: a SIBR request for view 0's camera, queued before iteration
    2's poll, comes back as H x W x 3 bytes equal to _viewer_render of the
    state at that poll, the client's end of stream drops the viewer, and
    training resumes (K1: 2 steps + 1 frame; K2 and K3: 2 steps).
    -> launches and the frame's host time (render to bytes)."""
    import socket
    import threading

    from opengaussian_tpu_torch.cameras import focal2fov
    from opengaussian_tpu_torch.config import Config, OptimizationConfig
    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.train.loop import Trainer

    out = os.path.join(root, "viewer")
    tr = Trainer(load_scene(scene_dir), Config(opt=OptimizationConfig(
        iterations=3, densify_from_iter=100)), out, device=dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tr.viewer_port = port
    try:
        tr.train(until=1, log_every=1)  # the first poll opens the listener
        served = tr.state
        cam = tr.bundle.camera(0)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3], w2c[:3, 3] = cam.R_w2c.cpu().numpy(), cam.t_w2c.cpu().numpy()
        req = dict(width=WIDTH, height=HEIGHT, w2c=w2c,
                   fovx=focal2fov(float(cam.fx), WIDTH), fovy=focal2fov(float(cam.fy), HEIGHT))
        reply = {}
        wrappers = zero_launches()
        with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
            c.sendall(sibr_request(w2c, WIDTH, HEIGHT, req["fovx"], req["fovy"]))
            c.shutdown(socket.SHUT_WR)

            def read():
                try:
                    reply["img"] = recv_exact(c, HEIGHT * WIDTH * 3)
                    n = int.from_bytes(recv_exact(c, 4), "little")
                    reply["path"] = recv_exact(c, n).decode()
                except OSError as e:
                    reply["error"] = repr(e)

            reader = threading.Thread(target=read, daemon=True)
            reader.start()
            tr.train(until=3, log_every=1)
            reader.join(timeout=120)
        launches = read_launches(wrappers, 3, "viewer", blend_stream_bwd=2, segment_reduce=2)
        if reader.is_alive() or "img" not in reply or reply.get("path") != out:
            raise AssertionError(f"viewer: no reply ({reply.get('error')})")
        if tr.iteration != 3 or tr.viewer.conn is not None:
            raise AssertionError("viewer: training did not resume without the viewer")
        current, tr.state = tr.state, served
        direct = tr._viewer_render(req, 1.0)
        frame_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            tr._viewer_render(req, 1.0)
            frame_s.append(time.perf_counter() - t0)
        tr.state = current
        if reply["img"] != direct:
            raise AssertionError("viewer: the served frame differs from a render of its camera")
        lit = float((np.frombuffer(direct, np.uint8).reshape(HEIGHT, WIDTH, 3) > 0)
                    .any(-1).mean())
        log(f"queries: viewer round trip at {WIDTH}x{HEIGHT}: {len(reply['img'])} bytes equal "
            f"to the render of the request's camera ({lit:.3f} of the pixels lit), training "
            f"resumed to iteration {tr.iteration}, launches {launches}; one frame (render to "
            f"bytes) " + ", ".join(f"{1e3 * s:.3f}" for s in frame_s) + f" ms [{card}]")
        return dict(launches=launches, frame_ms=1e3 * float(np.median(frame_s)))
    finally:
        if tr.viewer is not None:
            tr.viewer.close()


def queries_path(out: str, scene_dir: str, root: str, dev, card) -> dict:
    """The queries phase on the stream run's trained model (a copy, whose
    cluster_lang.npz is substituted): the text query, the two clicks, the
    card against the CPU at 160x120, the viewer round trip, and the times of
    render_selection alone and of LPIPS at full width.
    -> {"launches": {path: {kernel: launches}}, "errors": ..., times}."""
    import shutil

    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.eval.lpips import LPIPS, random_weights
    from opengaussian_tpu_torch.eval.metrics import read_rgb
    from opengaussian_tpu_torch.models.loading import load_model
    from opengaussian_tpu_torch.ops.knn import selection_mask
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render_selection

    model = os.path.join(root, "queries")
    pc = os.path.join("point_cloud", f"iteration_{TRAIN_ITERS}")
    shutil.copytree(os.path.join(out, pc), os.path.join(model, pc))
    shutil.copytree(os.path.join(out, "train", "ours"), os.path.join(model, "train", "ours"))
    shutil.copy(os.path.join(out, "cluster_lang.npz"), model)
    tf_zip, targets = substitute_lang_table(model, dev)
    text = text_query(model, scene_dir, tf_zip, targets, dev, card)
    clicks = {what: click_query(model, scene_dir, xy, dev, card, what,
                                must_render=what == "in a clustered root")
              for what, xy in click_pixels(model).items()}
    errors = check_queries_against_cpu(dev)
    viewer = viewer_round_trip(scene_dir, root, dev, card)

    # render_selection alone, on the first text's selection at full width
    state, kms, _ = load_model(model, device=dev)
    member, _ = selection_mask(kms.leaf_cls_ids.cpu().numpy(), state.alive.cpu().numpy(),
                               state.means.cpu().numpy(), text["recs"][0]["leaves"])
    member_t = torch.as_tensor(member, device=dev)
    camera = load_scene(scene_dir).train_views[0].camera
    ones = torch.ones(3, device=dev)
    with torch.no_grad():
        sel_ms = cuda_ms(lambda: render_selection(camera, state, ones, member_t,
                                                  RasterizeConfig()), iters=10, warmup=2)
    # LPIPS per view at full width, on cli.render's output of the trained model
    d = os.path.join(out, "train", "ours")
    a, b = (torch.as_tensor(read_rgb(os.path.join(d, sub, "00000.png")), device=dev)
            for sub in ("renders", "gt"))
    lpips = LPIPS(random_weights(seed=0), dev)
    lp_ms = cuda_ms(lambda: lpips(a, b), iters=3, warmup=1)
    log(f"timing: render_selection {sel_ms:.3f} ms ({int(member.sum())} splats selected, "
        f"{WIDTH}x{HEIGHT}, CUDA events); LPIPS {lp_ms:.3f} ms per {WIDTH}x{HEIGHT} view "
        f"(random weights, value {lpips(a, b):.5f}); viewer frame {viewer['frame_ms']:.3f} ms "
        f"[{card}]")
    launches = {"text query": text["launches"],
                **{f"click ({k})": c["launches"] for k, c in clicks.items()},
                "viewer": viewer["launches"]}
    return dict(launches=launches, errors=errors, sel_ms=sel_ms, lp_ms=lp_ms,
                frame_ms=viewer["frame_ms"])


# --- phase 9: tile windows, tile bands and the mesh at world size 1 ---

T_EPS_TOL = 2e-4  # a window's own early stop leaves at most T_EPS per pixel
MESH_STEPS = 10
MESH_TOL = 1e-3  # normalised, the repo's gradient tolerance, after MESH_STEPS steps


def poisoned(rows, ids, n: int, chunk: int):
    """rows [P, F] and their splat ids [P], followed by a chunk of NaN rows
    of id n: the dead windows start at P, so a kernel that read a dead
    window's rows would blend NaN."""
    return (torch.cat([rows, rows.new_full((chunk, rows.shape[1]), float("nan"))]),
            torch.cat([ids, ids.new_full((chunk,), n)]))


def path_launches(wrappers: dict, what: str, *need: str) -> dict:
    """The launches since zero_launches; raise unless each kernel in `need`
    launched."""
    torch.cuda.synchronize()
    got = {k: w.launches for k, w in wrappers.items()}
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"{what}: no launch of {missing}: {got}")
    log(f"launches, {what}: {got}")
    return got


def windows_phase(tr, chunk: int, card: str) -> dict:
    """Tile windows on the stream run's trained state. The budget tuner's
    window branch (a base config with tile_windows > 0): K = WINDOW_K and
    S = ceil(1.3 x the probe's deepest tile / K), window_extra from the
    probe. On the training frame (view 0's feature pass, C = 7) binned
    under it: S, Tv, the live and dead windows (count 0, start at the
    stream's end, where NaN rows follow: `poisoned`), nothing truncated or
    dropped; K1, K2 and K4 bit for bit with their plain versions on the
    virtual tiles, K2 and K4 with the per-window cotangents that autograd of
    _fold_windows gives from the stage-1 loss's, and K3 over K2's rows; the
    folded image within T_EPS_TOL of the unwindowed one (the tuner's config
    without windows, K grown past the deepest tile). Then, in turns
    windowed and unwindowed, K1, K2 and K4 device time per launch, each
    walk's deepest (virtual) tile alone, the fold's time, and a stage-1
    step eager and captured (through each config's frozen plans), the
    captured windowed step against the eager one. The main path counted:
    the windowed stage-1 step eager (K2, and K4 with bwd_layout "compact")
    and captured. -> the numbers."""
    from opengaussian_tpu_torch.ops import budget
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import (
        RasterizeConfig,
        _fold_windows,
        _images,
        build_frozen_plan,
        stack_plans,
    )

    V, n = tr.bundle.num_views, tr.state.capacity
    cams = [tr.bundle.camera(v) for v in range(V)]
    _, deepest = budget.probe(tr.state, cams)
    win_cfg = budget.tuned_config(RasterizeConfig(tile_windows=1), tr.state, cams)
    wx = budget.probe.last_window_extras
    flat_cfg = budget.tuned_config(RasterizeConfig(), tr.state, cams)
    S = win_cfg.tile_windows
    want_s = math.ceil(deepest * budget.HEADROOM / budget.WINDOW_K)
    if win_cfg.max_per_tile != budget.WINDOW_K or S != want_s or S < 2:
        raise AssertionError(f"the tuner's window branch: K {win_cfg.max_per_tile}, S {S}, "
                             f"for a deepest tile of {deepest} (want K {budget.WINDOW_K}, "
                             f"S {want_s} >= 2)")
    cam = cams[0]
    with torch.no_grad():
        rows, counts, tstart, toff, gx, bins, _ = frame_streams(cam, tr.state, win_cfg)[7]
        f_rows, f_counts, f_tstart, f_toff, _, f_bins, _ = frame_streams(cam, tr.state,
                                                                         flat_cfg)[7]
    P, F = rows.shape
    Tv, band = counts.shape[0], bins.vt_n.shape[0]
    used = int(bins.vt_n.sum())
    dead = torch.arange(Tv, device=counts.device) >= used
    lost = [int(b.n_truncated) for b in (bins, f_bins)] + [int(b.n_dropped) for b in (bins, f_bins)]
    log(f"windows: the tuner's window branch on the trained state: deepest tile {deepest}, "
        f"K = {win_cfg.max_per_tile}, S = {S}, window_extra = {win_cfg.window_extra} (the "
        f"probe's extra windows by depth {wx}), P = {win_cfg.intersection_budget}; without "
        f"windows K = {flat_cfg.max_per_tile}. Training frame: {band} tiles, Tv = {Tv} "
        f"virtual tiles, {used} windows in use ({int((bins.vt_n > 1).sum())} tiles split, "
        f"{int((counts > 0).sum())} windows with slots), {int(dead.sum())} dead; deepest "
        f"window {int(counts.max())} of the deepest tile's {int(f_counts.max())}; "
        f"n_truncated {lost[0]} (unwindowed {lost[1]}), n_dropped {lost[2]} ({lost[3]})")
    if any(lost):
        raise AssertionError(f"windows: the training frame lost slots {lost}")
    if not bool(dead.any()) or bool(counts[dead].any()) or not bool((tstart[dead] == P).all()):
        raise AssertionError("windows: the frame's dead windows are missing or not at P")
    # the kernels on the virtual tiles, bit for bit, dead windows over NaN rows
    prow, pids = poisoned(rows, bins.sorted_gauss, n, chunk)
    with torch.no_grad():
        acc, t_fin = rk.blend_stream_fwd(prow, counts, tstart, toff, gx, chunk)
        torch.cuda.synchronize()
        acc_p, t_p, work_f = rk.blend_stream_fwd_plain(rows, counts, tstart, toff, gx, chunk,
                                                        count_work=True)
    k1 = max(compare(f"blend_stream_fwd C=7 windowed training frame {nm}", x, y, 0.0, 0.0)
             for nm, x, y in (("accum", acc, acc_p), ("t_final", t_fin, t_p)))
    a = acc.clone().requires_grad_(True)
    tt = t_fin.clone().requires_grad_(True)
    acc_w, t_w = _fold_windows(a, tt, bins.vt_first, bins.vt_n, S)
    grids = (gx, (HEIGHT + 15) // 16)
    sam = (tr.bundle.sam_ids[0], tr.bundle.max_masks, tr.cfg.opt.loss_weight)
    cot_f = stage1_cotangents(cam, grids, acc_w.detach(), t_w.detach(), *sam)
    cot = tuple(g.contiguous() for g in torch.autograd.grad((acc_w, t_w), (a, tt), cot_f))
    acc_w, t_w = acc_w.detach(), t_w.detach()
    d = rk.blend_stream_bwd(prow, counts, tstart, toff, acc, t_fin, *cot, gx, chunk)
    torch.cuda.synchronize()
    d_p, work_b = rk.blend_stream_bwd_plain(rows, counts, tstart, toff, acc, t_fin, *cot, gx,
                                            chunk, count_work=True)
    k2 = compare("blend_stream_bwd C=7 windowed training frame d_rows", d[:P], d_p, 0.0, 0.0)
    if bool(d[P:].any()) or float(d_p.abs().max()) == 0.0:
        raise AssertionError("K2, windows: rows past the stream written, or no gradient")
    per = rk.segment_reduce(d, pids, n)
    per_p = rk.segment_reduce_plain(d_p, bins.sorted_gauss, n)
    k3 = compare("segment_reduce per-splat (K2's windowed rows)", per, per_p, grad_atol(per_p),
                 GRAD_TOL["rtol"])
    cargs = (counts, tstart, toff)
    d4, ids4 = rk.blend_stream_bwd_compact(prow, *cargs, pids, acc, t_fin, *cot, gx, chunk, n)
    torch.cuda.synchronize()
    d4_p, ids4_p = rk.blend_stream_bwd_compact_plain(rows, *cargs, bins.sorted_gauss, acc, t_fin,
                                                     *cot, gx, chunk, n)
    nc = rk.compact_offsets(counts, chunk)[1] * chunk
    k4 = compare("blend_stream_bwd_compact C=7 windowed training frame d_rows", d4[:nc],
                 d4_p[:nc], 0.0, 0.0)
    if not torch.equal(ids4[:nc], ids4_p[:nc]) or bool((ids4[nc:] != n).any()):
        raise AssertionError("K4, windows: the ids differ from the plain version's")
    del d4, ids4, d4_p, ids4_p, per, per_p
    log(f"windows: K1, K2 and K4 bit for bit with their plain versions on the {Tv} virtual "
        f"tiles ({P} slots; the dead windows' starts at P over {chunk} NaN rows), K3 over "
        f"K2's rows within its tolerance; work K1 "
        + ", ".join(f"{k} {v}" for k, v in work_f.items())
        + "; work K2 " + ", ".join(f"{k} {v}" for k, v in work_b.items()))
    # the folded tiles against the unwindowed ones
    with torch.no_grad():
        f_acc, f_t = rk.blend_stream_fwd(f_rows, f_counts, f_tstart, f_toff, gx, chunk)
        bg6 = torch.zeros(6, device=acc.device)
        fw, aw, dw = (x[0] for x in _images(cam, grids, acc_w, t_w, bg6))
        ff, af, df = (x[0] for x in _images(cam, grids, f_acc, f_t, bg6))
    # a window's own stop composites, past the whole tile's stop, at most the
    # transmittance left there, T_EPS / (1 - alpha) of the slot that stopped
    # it; the payload's scale multiplies that (depth's too)
    a_max = min(float(rows[:, 5].max()), 0.99)
    fold_err = {"features": compare("windowed feature image against unwindowed", fw, ff,
                                    T_EPS_TOL, 1e-4),
                "alpha": compare("windowed alpha against unwindowed", aw, af, T_EPS_TOL, 0.0),
                "depth": compare("windowed depth against unwindowed", dw, df,
                                 T_EPS_TOL * float(df.abs().max()), 1e-4)}
    log(f"windows: the folded tiles against the unwindowed ones, features / alpha / depth "
        f"within {fold_err['features']:.3e} / {fold_err['alpha']:.3e} / "
        f"{fold_err['depth']:.3e}; the gate {T_EPS_TOL} (x the largest depth); the frame's "
        f"largest opacity {a_max:.4f}, so T_EPS / (1 - alpha) = {1e-4 / (1 - a_max):.3e}")
    # in turns: the kernels, the deepest tile alone, the fold
    f_cot = stage1_cotangents(cam, grids, f_acc, f_t, *sam)
    fc = (f_counts, f_tstart, f_toff)
    cases = {
        "K1": ("blend_stream_fwd_kernel",
               lambda c=counts: rk.blend_stream_fwd(rows, c, tstart, toff, gx, chunk),
               lambda c=f_counts: rk.blend_stream_fwd(f_rows, c, f_tstart, f_toff, gx, chunk)),
        "K2": ("blend_stream_bwd_kernel",
               lambda: rk.blend_stream_bwd(rows, *cargs, acc, t_fin, *cot, gx, chunk),
               lambda: rk.blend_stream_bwd(f_rows, *fc, f_acc, f_t, *f_cot, gx, chunk)),
        "K4": ("blend_stream_bwd_compact_kernel",
               lambda: rk.blend_stream_bwd_compact(rows, *cargs, bins.sorted_gauss, acc, t_fin,
                                                   *cot, gx, chunk, n),
               lambda: rk.blend_stream_bwd_compact(f_rows, *fc, f_bins.sorted_gauss, f_acc, f_t,
                                                   *f_cot, gx, chunk, n)),
    }
    times = {}
    with torch.no_grad():
        for name, (kern, w, u) in cases.items():
            times[name] = [device_ms(f, 10, kern) for f in (w, u, u, w)]
        # one (virtual) tile, the deepest, alone: its walk sets the launch's least time
        alone = lambda c: torch.where(  # noqa: E731
            torch.arange(c.shape[0], device=c.device) == torch.argmax(c), c, 0)
        w_only, u_only = alone(counts), alone(f_counts)
        times["K1 deepest alone"] = [
            device_ms(f, 20, "blend_stream_fwd_kernel") for f in (
                lambda: rk.blend_stream_fwd(rows, w_only, tstart, toff, gx, chunk),
                lambda: rk.blend_stream_fwd(f_rows, u_only, f_tstart, f_toff, gx, chunk))]
        fold = lambda: _fold_windows(acc, t_fin, bins.vt_first, bins.vt_n, S)  # noqa: E731
        fold_ms, fold_dev = cuda_ms(fold, iters=20, warmup=2), device_ms(fold, 10)
    for name, v in times.items():
        log(f"timing: windows, training frame, {name} device ms in turns windowed, unwindowed"
            + (", unwindowed, windowed" if len(v) == 4 else "") + ": "
            + ", ".join(f"{x:.4f}" for x in v) + f" [{card}]")
    log(f"timing: windows, _fold_windows over {band} tiles x {S} windows: {fold_ms:.4f} ms a "
        f"call, device time {fold_dev:.4f} ms [{card}]")
    # the stage-1 step, eager and captured through each config's frozen plans
    cov3d = build_cov3d(tr.state.scales, tr.state.quats)
    cfgs = {"windowed": win_cfg, "unwindowed": flat_cfg}
    ew, eu = eager_step(tr, "1", rcfg=win_cfg), eager_step(tr, "1", rcfg=flat_cfg)
    step_loss = abs(float(ew[3]) - float(eu[3])) / abs(float(eu[3]))
    eager_ms = {k: [] for k in cfgs}
    for k in ("windowed", "unwindowed", "unwindowed", "windowed"):
        eager_ms[k].append(cuda_ms(lambda k=k: eager_step(tr, "1", rcfg=cfgs[k]), iters=10))
    wrappers = zero_launches()
    eager_step(tr, "1", rcfg=win_cfg)
    eager_step(tr, "1", rcfg=dataclasses.replace(win_cfg, bwd_layout="compact"))
    saved = (tr.rcfg, tr.autotune_budgets)
    tr.autotune_budgets = True
    steps, plans = {}, {}
    try:
        row = tr._step_row("1", STEP_ITS["1"], 0, tr._bg_values("1"), 1.0, 0,
                           tr.adam.count + 1).to(tr.device)
        for k, c in cfgs.items():
            tr._set_rcfg(c)
            plans[k] = stack_plans([build_frozen_plan(tr.bundle.camera(v), tr.state.means, cov3d,
                                                      tr.state.opacity, c) for v in range(V)], n)
            if int((plans[k].n_dropped + plans[k].n_truncated).sum()):
                raise AssertionError(f"windows: the {k} frozen plans lost slots")
            steps[k] = tr._captured_step("1", False, plans[k])
            loss = steps[k].run(row)
            if k == "windowed":
                e = eager_step(tr, "1", rcfg=c, frozen=plans[k].select(0))
                io = steps[k].io
                cap_err = step_error(tr, (io["state"], io["mu"], io["nu"], None, loss,
                                          io["lost"]), (e[0], e[1], None, e[3], e[4]),
                                     "captured windowed stage-1 step")
                launches = path_launches(wrappers, "windowed stage-1 steps (eager stream and "
                                         "compact, captured)", "blend_stream_fwd",
                                         "blend_stream_bwd", "blend_stream_bwd_compact",
                                         "segment_reduce")
            tr._captured.clear()  # one graph per stage: keep each aside
        cap_ms = {k: [] for k in cfgs}
        for k in ("windowed", "unwindowed", "unwindowed", "windowed"):
            steps[k].copy_in(tr)
            cap_ms[k].append(cuda_ms(lambda k=k: steps[k].run(row), iters=10))
    finally:
        tr._set_rcfg(saved[0])
        tr.autotune_budgets = saved[1]
    del steps
    log(f"timing: windows, stage-1 step ms in turns windowed, unwindowed, unwindowed, "
        f"windowed: eager {eager_ms['windowed'][0]:.3f}, {eager_ms['unwindowed'][0]:.3f}, "
        f"{eager_ms['unwindowed'][1]:.3f}, {eager_ms['windowed'][1]:.3f}; captured through "
        f"frozen plans ({plans['windowed'].nbytes() / 2**20:.1f} / "
        f"{plans['unwindowed'].nbytes() / 2**20:.1f} MiB) {cap_ms['windowed'][0]:.3f}, "
        f"{cap_ms['unwindowed'][0]:.3f}, {cap_ms['unwindowed'][1]:.3f}, "
        f"{cap_ms['windowed'][1]:.3f}; the eager steps' losses differ by {step_loss:.2e} "
        f"(relative), the captured windowed step against the eager one {cap_err:.2e} [{card}]")
    return dict(win_cfg=win_cfg, flat_cfg=flat_cfg, S=S, Tv=Tv, band=band, used=used,
                dead=int(dead.sum()), deepest=deepest, k1_err=k1, k2_err=k2, k3_err=k3,
                k4_err=k4, fold_err=fold_err, times=times, fold_ms=fold_ms, fold_dev=fold_dev,
                eager_ms=eager_ms, cap_ms=cap_ms, cap_err=cap_err, launches=launches)


def bands_phase(state, cam_r, tr, k_render: int, card: str) -> dict:
    """rasterize_banded(bands=4) against rasterize on the render frame (the
    loaded model's color pass of view 0, C = 4) and the training frame (the
    trained state's feature pass of view 0, C = 7), in the stream and dense
    layouts and, on the training frame, the compact backward: the images
    (expected equal bit for bit; the largest difference logged) and the
    gradients by means, opacities and payload (to K3's tolerance), each
    band's slots, and the banded calls' launches (4 of K1 or K5, 4 of the
    backward and of K3), and the forward render banded and whole in turns
    (stream layout). -> {"launches", "errs", "times"}."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import (
        RasterizeConfig,
        _prepare,
        rasterize,
        rasterize_banded,
    )
    from opengaussian_tpu_torch.ops.sh import sh_to_rgb
    from opengaussian_tpu_torch.render import encoded_ins_feat

    bands = 4
    cam_t = tr.bundle.camera(0)
    frames = {
        "render frame C=4": (cam_r.to(state.device), state, k_render, (
            lambda st, c: sh_to_rgb(3, st.sh, st.means, c.cam_center))),
        "training frame C=7": (cam_t, tr.state, tr.rcfg.max_per_tile, (
            lambda st, c: encoded_ins_feat(st, origin_feat=True)))}
    layouts = {"stream": {}, "dense": {"pallas_input": "dense"},
               "compact": {"bwd_layout": "compact"}}
    total, errs, times = {}, {}, {}
    for fname, (cam, st, K, payload_of) in frames.items():
        cov = build_cov3d(st.scales, st.quats).detach()
        with torch.no_grad():
            pay = payload_of(st, cam).detach()
        bg = torch.zeros(pay.shape[1], device=st.device)
        gen = torch.Generator(device=st.device).manual_seed(3)
        wts = torch.rand((HEIGHT, WIDTH, pay.shape[1]), generator=gen, device=st.device)
        for lay, upd in layouts.items():
            if lay == "compact" and not fname.startswith("training"):
                continue
            cfg = RasterizeConfig(max_per_tile=K, **upd)

            def run(fn, **kw):
                leaves = [x.detach().clone().requires_grad_(True)
                          for x in (st.means, st.opacity, pay)]
                r = fn(cam, leaves[0], cov, leaves[1], leaves[2], bg, cfg, **kw)
                loss = (r.image * wts).sum() + 0.1 * r.alpha.sum() + 0.01 * r.depth.sum()
                return r, torch.autograd.grad(loss, leaves)

            wrappers = zero_launches()
            banded, gb = run(rasterize_banded, bands=bands)
            fwd = "blend_tiles_fwd" if lay == "dense" else "blend_stream_fwd"
            bwd = {"stream": "blend_stream_bwd", "dense": "blend_tiles_bwd",
                   "compact": "blend_stream_bwd_compact"}[lay]
            got = path_launches(wrappers, f"rasterize_banded, {fname}, {lay}", fwd, bwd,
                                "segment_reduce")
            if (got[fwd], got[bwd], got["segment_reduce"]) != (bands, bands, bands):
                raise AssertionError(f"rasterize_banded: launches {got}, not {bands} each")
            total = {k: total.get(k, 0) + v for k, v in got.items()}
            full, gf = run(rasterize)
            e = max(compare(f"rasterize_banded {k}, {fname}, {lay}",
                            getattr(banded, k).detach(), getattr(full, k).detach(),
                            TOL["atol"], TOL["rtol"])
                    for k in ("image", "alpha", "depth"))
            g = max(compare(f"rasterize_banded d {nm}, {fname}, {lay}", x, y, grad_atol(y),
                            GRAD_TOL["rtol"])
                    for nm, x, y in zip(("means", "opacities", "payload"), gb, gf))
            lost = [int(x) for x in (banded.n_dropped, banded.n_truncated, full.n_dropped,
                                     full.n_truncated)]
            if any(lost):
                raise AssertionError(f"rasterize_banded, {fname}, {lay}: lost {lost}")
            with torch.no_grad():
                gx, gy = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
                per = -(-gy // bands)
                slots = []
                for r0 in range(0, gy, per):
                    _, b, _ = _prepare(cam, st.means, cov, st.opacity, cfg, tile_lo=r0 * gx,
                                       tile_hi=min(gy, r0 + per) * gx)
                    slots.append(int(b.counts.sum()))
            errs[(fname, lay)] = (e, g)
            if lay == "stream":  # the forward render, banded and whole, in turns
                with torch.no_grad():
                    fns = {"banded": lambda: rasterize_banded(cam, st.means, cov, st.opacity,
                                                              pay, bg, cfg, bands=bands),
                           "whole": lambda: rasterize(cam, st.means, cov, st.opacity, pay, bg,
                                                      cfg)}
                    ms = [(k, cuda_ms(fns[k], iters=5)) for k in ("banded", "whole", "whole",
                                                                  "banded")]
                times[fname] = ms
                log(f"timing: bands, {fname}: the forward render ms in turns "
                    + ", ".join(f"{k} {v:.3f}" for k, v in ms) + f" [{card}]")
            log(f"bands: rasterize_banded(bands={bands}), {fname}, {lay}: images against "
                f"rasterize {'equal bit for bit' if e == 0.0 else f'max abs err {e:.3e}'}, "
                f"gradients within {g:.3e}; slots per band {slots} (sum {sum(slots)}), "
                f"max_per_tile {K}; launches {got} [{card}]")
    return dict(launches=total, errs=errs, times=times)


def mesh_phase(tr, cfg, card: str, backend: str = "nccl") -> dict:
    """The mesh at world size 1 on `backend` (NCCL: one process on the one
    card, in this process): render_sharded against rasterize on the
    training frame's color pass, bands off and on (the band budget the
    frame's P), in the stream, dense and compact configurations, images and
    radii (bit for bit expected) and gradients by means; MESH_STEPS sharded
    stage-0 steps against as many single-device stage-0 steps from the
    trained state, with the same views and backgrounds: the losses and the
    parameters, Adam's moments and the densification statistics after
    them, within MESH_TOL normalised; the stage-0 step of each in turns;
    scaling_bench(sizes=[1]). No figure here speaks of more than one GPU.
    -> {"launches", "errs", ...}."""
    import datetime
    import socket

    import torch.distributed as dist

    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import rasterize
    from opengaussian_tpu_torch.ops.sh import sh_to_rgb
    from opengaussian_tpu_torch.parallel.distributed import scaling_bench
    from opengaussian_tpu_torch.parallel.mesh import make_mesh, shard_gaussians
    from opengaussian_tpu_torch.parallel.render import render_sharded
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps
    from opengaussian_tpu_torch.train import loop

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(minutes=5))
    try:
        mesh = make_mesh()
        n, V, o = tr.state.capacity, tr.bundle.num_views, tr.cfg.opt
        cam = tr.bundle.camera(0)
        st = shard_gaussians(mesh, tr.state)
        cov = build_cov3d(st.scales, st.quats).detach()
        with torch.no_grad():
            rgb = sh_to_rgb(3, st.sh, st.means, cam.cam_center)
        band = dataclasses.replace(cfg, band_intersection_budget=cfg.max_intersections(n))
        cases = {"stream": cfg, "stream, bands": band,
                 "dense, bands": dataclasses.replace(band, pallas_input="dense"),
                 "compact, bands": dataclasses.replace(band, bwd_layout="compact")}
        gen = torch.Generator(device=tr.device).manual_seed(5)
        wts = torch.rand((HEIGHT, WIDTH, 3), generator=gen, device=tr.device)

        def grads_of(fn, c):
            means = st.means.detach().clone().requires_grad_(True)
            out = fn(means, c)
            return out, torch.autograd.grad((out[0] * wts).sum() + out[1].sum(), means)[0]

        sharded = lambda m, c: render_sharded(mesh, cam, m, cov, st.opacity, rgb,  # noqa: E731
                                              tr.bg, c)

        def single(m, c):
            r = rasterize(cam, m, cov, st.opacity, rgb, tr.bg,
                          dataclasses.replace(c, band_intersection_budget=0))
            return r.image, r.alpha, r.depth, r.radii, r.n_dropped + r.n_truncated

        wrappers = zero_launches()
        outs = {k: grads_of(sharded, c) for k, c in cases.items()}
        vis = [i % V for i in range(MESH_STEPS)]
        bgs = np.random.default_rng(9).random((MESH_STEPS, 3)).astype(np.float32)
        its = [STEP_ITS["0"] + i for i in range(MESH_STEPS)]
        steps = make_sharded_steps(mesh, cfg, o, tr.spatial_lr_scale)
        s2, a2, sa2 = shard_gaussians(mesh, (tr.state, tr.adam, tr.stats))
        loss_sh = []
        for i, vi in enumerate(vis):
            s2, a2, sa2, loss, aux = steps.stage0(
                s2, a2, sa2, tr.bundle.camera(vi), tr.bundle.gt_images[vi],
                tr.bundle.alpha_masks[vi], its[i], torch.as_tensor(bgs[i], device=tr.device),
                has_alpha=tr.bundle.has_alpha[vi])
            loss_sh.append(float(loss))
        launches = path_launches(wrappers, "the mesh at world size 1 (4 sharded renders "
                                 f"with their backward, {MESH_STEPS} sharded stage-0 steps)",
                                 "blend_stream_fwd", "blend_stream_bwd", "segment_reduce",
                                 "blend_tiles_fwd", "blend_tiles_bwd",
                                 "blend_stream_bwd_compact")
        errs = {}
        for k, c in cases.items():
            (img, alpha, depth, radii, lost), g = outs[k]
            (r_img, r_alpha, r_depth, r_radii, r_lost), r_g = grads_of(single, c)
            e = max(compare(f"render_sharded {nm} ({k}), world 1", x.detach(), y.detach(),
                            TOL["atol"], TOL["rtol"])
                    for nm, x, y in (("image", img, r_img), ("alpha", alpha, r_alpha),
                                     ("depth", depth, r_depth)))
            ge = compare(f"render_sharded d means ({k}), world 1", g, r_g, grad_atol(r_g),
                         GRAD_TOL["rtol"])
            if not torch.equal(radii, r_radii) or int(lost) or int(r_lost):
                raise AssertionError(f"render_sharded ({k}): radii differ or slots lost "
                                     f"({int(lost)}, {int(r_lost)})")
            errs[k] = (e, ge)
        del outs
        s1, a1, sa1, loss_1 = tr.state, tr.adam, tr.stats, []
        for i, vi in enumerate(vis):
            s1, a1, sa1, loss, _p, lost = loop.stage0_step(
                s1, a1, sa1, tr.bundle, vi, its[i], torch.as_tensor(bgs[i], device=tr.device),
                tr.spatial_lr_scale, cfg, o)
            loss_1.append(float(loss))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_sh, loss_1))
        pairs = ([(f"param {k}", getattr(s2, k), getattr(s1, k)) for k in s1.params()]
                 + [(f"mu {k}", a2.mu[k], a1.mu[k]) for k in a1.mu]
                 + [(f"nu {k}", a2.nu[k], a1.nu[k]) for k in a1.nu]
                 + [(f"stats {f.name}", getattr(sa2, f.name), getattr(sa1, f.name))
                    for f in dataclasses.fields(sa1)])
        step_errs = {nm: normalised_err(x.float(), y.float().cpu()) for nm, x, y in pairs}
        worst = max(step_errs.values())
        if loss_err > MESH_TOL or worst > MESH_TOL:
            raise AssertionError(f"{MESH_STEPS} sharded stage-0 steps against single-device "
                                 f"ones: losses {loss_err:.3e}, state {step_errs}")
        del s1, a1, sa1
        # one step each, in turns, from the trained state
        fns = {"single": lambda: loop.stage0_step(tr.state, tr.adam, tr.stats, tr.bundle, 0,
                                                  its[0], tr.bg, tr.spatial_lr_scale, cfg, o),
               "sharded": lambda: steps.stage0(
                   st, tr.adam, tr.stats, cam, tr.bundle.gt_images[0],
                   tr.bundle.alpha_masks[0], its[0], tr.bg, has_alpha=tr.bundle.has_alpha[0])}
        turns = [(k, cuda_ms(fns[k], iters=10)) for k in ("single", "sharded", "sharded",
                                                          "single")]
        rows = scaling_bench(sizes=[1])
    finally:
        dist.destroy_process_group()
    log(f"mesh, world size 1 on {backend}: render_sharded against rasterize "
        + ", ".join(f"{k} {e:.3e} (d means {g:.3e})" for k, (e, g) in errs.items())
        + f"; {MESH_STEPS} sharded stage-0 steps against single-device steps: losses within "
        f"{loss_err:.3e} relative, parameters, moments and statistics within {worst:.3e} "
        f"normalised (worst {max(step_errs, key=step_errs.get)}); stage-0 step ms in turns "
        + ", ".join(f"{k} {v:.3f}" for k, v in turns) + f"; scaling_bench(sizes=[1]) {rows}"
        f" [{card}]; more than one GPU: not measured (one card)")
    return dict(launches=launches, errs=errs, loss_err=loss_err, state_err=worst,
                turns=turns, scaling=rows)


# --- phase 10: the mesh trainer at world size 1 on NCCL ---

# the mesh run trains without train_path's opacity reset at 30: ten stage-0
# steps after that reset no root's render reaches the 0.8 alpha of sweep 2's
# gates at this width (roots occurring per view [0, 0, 0], the roots' alpha
# peaks in view 0 at most 0.591 on an H100), and the stage-2.2 steps train
# nothing
MESH_RUN_FLAGS = ("--opacity_reset_interval", "1000")


def _hold_step(name: str, got: tuple, want: tuple, params) -> float:
    """A sharded step's (state, adam, loss, ..., n_lost) against the
    single-device step's: the loss within 1e-5 relative, n_lost (and stage
    2.2's ok) equal, every parameter and Adam moment within MESH_TOL
    normalised. -> the largest normalised error."""
    (s1, a1, l1, *r1), (s2, a2, l2, *r2) = got, want
    if [bool(x) if x.dtype == torch.bool else int(x) for x in r1] != \
            [bool(x) if x.dtype == torch.bool else int(x) for x in r2]:
        raise AssertionError(f"{name}: ok / n_lost {r1} against {r2}")
    loss_err = abs(float(l1) - float(l2)) / max(abs(float(l2)), 1e-12)
    errs = [normalised_err(getattr(s1, k), getattr(s2, k).cpu()) for k in params]
    errs += [normalised_err(a1.mu[k], a2.mu[k].cpu()) for k in params]
    errs += [normalised_err(a1.nu[k], a2.nu[k].cpu()) for k in params]
    worst = max(errs)
    if loss_err > 1e-5 or worst > MESH_TOL:
        raise AssertionError(f"{name}: loss {float(l1)!r} against {float(l2)!r}, state within "
                             f"{worst:.3e} (tolerance {MESH_TOL})")
    log(f"mesh trainer hold, {name}: loss {float(l1):.6f} within {loss_err:.2e} relative "
        f"(tolerance 1e-5), parameters and moments within {worst:.2e} normalised "
        f"(tolerance {MESH_TOL}), n_lost {int(r1[-1])}")
    return worst


def _stage_pairs(steps, loop, tr, cfg, live) -> dict:
    """{stage: (sharded step, single-device step)} from the trainer's state,
    each -> (state, adam, loss, [ok,] n_lost): view 0 (stage 2.2: root and
    view `live`), rescale 1, the trainer's background."""
    st, adam, b, bg, o, pf = tr.state, tr.adam, tr.bundle, tr.bg, tr.cfg.opt, tr.pseudo.feat
    cam, (r22, v22) = b.camera(0), live

    def sharded0():
        s, a, _stats, loss, aux = steps.stage0(st, adam, tr.stats, cam, b.gt_images[0], None,
                                               STEP_ITS["0"], bg)
        return s, a, loss, aux["n_lost"]

    def single0():
        s, a, _stats, loss, _psnr, lost = loop.stage0_step(st, adam, tr.stats, b, 0,
                                                           STEP_ITS["0"], bg,
                                                           tr.spatial_lr_scale, cfg, o)
        return s, a, loss, lost

    return {
        "0": (sharded0, single0),
        "1": (lambda: steps.stage1(st, adam, cam, b.sam_ids[0], None, STEP_ITS["1"], bg, 1.0,
                                   b.max_masks),
              lambda: loop.stage1_step(st, adam, b, 0, STEP_ITS["1"], bg, 1.0, cfg, o)),
        "2.1": (lambda: steps.stage21(st, adam, tr.kms, cam, pf[0], None, STEP_ITS["2.1"], bg,
                                      1.0),
                lambda: loop.stage21_step(st, adam, tr.kms, b, 0, STEP_ITS["2.1"], bg, 1.0,
                                          pf[0], cfg, o)),
        "2.2": (lambda: steps.stage22(st, adam, tr.kms, b.camera(v22), pf[v22], r22, True, None,
                                      STEP_ITS["2.2"], bg, 1.0),
                lambda: loop.stage22_step(st, adam, tr.kms, b, v22, STEP_ITS["2.2"], bg, 1.0,
                                          pf[v22], r22, True, cfg, o))}


def mesh_trainer_phase(scene_dir: str, root: str, dev, chunk: int, card: str) -> dict:
    """The mesh trainer at world size 1 on NCCL, through the entry point a
    user runs: `cli.train.main(["--mesh", "1", ...])` starts a process group
    of one in this process and trains TRAIN_ITERS iterations over it, stages
    0 to 3 with train_path's schedule but no opacity reset
    (MESH_RUN_FLAGS), the SAM refiner before stage 1, and a checkpoint:
    every step through parallel/steps.py, the sweeps and stage 3 through
    parallel/sweeps.py (the group entry of K5 at the rank's tile offset, one
    launch per view in sweep 2 and per root and view in stage 3), the
    refiner's passes through parallel/refine.py. Checks the launches of
    that schedule, the losses, the PLYs, codebooks, cluster_lang.npz and the
    checkpoint (reloaded bit for bit), and logs the roots occurring per view
    and the stage-2.2 loss. Then, on the trained state, one sharded step of
    each stage against the single-device step, in the stream, dense and
    compact configurations, stage 2.2 on a root whose render occurs (sweep
    2's verdict for the view when one passes), and the two in turns;
    eval_render against render; sweeps 1 and 2 and the stage-3 association
    of each view against the single-device sweeps, in turns; the sharded
    refiner against the single-device one on refiner_two_blobs; and the
    group entry of K5 at a tile offset bit for bit with its plain version.
    No figure here speaks of more than one GPU. -> {"launches" (the
    training run's), "hold_launches" (the sharded holds'), errors, times}."""
    import torch.distributed as dist

    from opengaussian_tpu_torch.cli import train as cli_train
    from opengaussian_tpu_torch.data.ply import load_gaussian_ply
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import _prepare, gather_rows
    from opengaussian_tpu_torch.parallel.refine import make_refiner_fns
    from opengaussian_tpu_torch.parallel.render import _tile_slice
    from opengaussian_tpu_torch.parallel.steps import make_sharded_steps
    from opengaussian_tpu_torch.refine import sam_refiner as sr
    from opengaussian_tpu_torch.render import render
    from opengaussian_tpu_torch.train import checkpoint, lang, loop, pseudo
    from opengaussian_tpu_torch.utils.codebook import load_codebook

    out = os.path.join(root, "trained_mesh")
    flags = [x for k, v in STAGE_ENDS.items() for x in (f"--{k}", str(v))]
    wrappers = zero_launches()
    t0 = time.perf_counter()
    tr = cli_train.main(
        ["-s", scene_dir, "-m", out, "--iterations", str(TRAIN_ITERS), *flags,
         "--densify_from_iter", "10", "--densification_interval", "10",
         "--leaf_update_fr", str(LEAF_UPDATE_FR), "--checkpoint_iterations", str(TRAIN_ITERS),
         "--enable_multiview_sam_refinement", *MESH_RUN_FLAGS, "--mesh", "1"], device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    try:
        mesh, o, V = tr.mesh, tr.cfg.opt, tr.bundle.num_views
        what = "mesh trainer (world size 1, NCCL)"
        log(f"{what}: {TRAIN_ITERS} iterations, the refiner and stage 3 through cli.train "
            f"--mesh 1 in {seconds:.2f} s, launches {launches}")
        # the steps; the refiner's depth render and sweep 1 (at 2.1 and 2.2
        # entry) per view; the group entry once per view in sweep 2 and per
        # root and view in stage 3
        want = dict.fromkeys(launches, 0)
        want["blend_stream_fwd"] = TRAIN_ITERS + 3 * V
        want["blend_stream_bwd"] = want["segment_reduce"] = TRAIN_ITERS
        want["blend_tiles_fwd_groups"] = V + o.root_node_num * V
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, expected {want}")
        losses = torch.stack(tr.losses).cpu().numpy()
        m = [float(losses[i:i + 10].mean()) for i in range(0, TRAIN_ITERS, 10)]
        occur = tr.pseudo.cluster_occur.sum(dim=1).tolist()
        s22 = losses[STAGE_ENDS["start_leaf_cb_iter"]:]
        log(f"{what}: loss by step " + " ".join(f"{x:.5f}" for x in losses))
        log(f"{what}: mean loss of steps 1-10, ..., {TRAIN_ITERS - 9}-{TRAIN_ITERS}: "
            + ", ".join(f"{x:.5f}" for x in m) + f"; capacity {tr.state.capacity}, alive "
            f"{tr._num_alive()}, max_per_tile {tr.rcfg.max_per_tile}, leaf_sub_num "
            f"{tr.kms.leaf_sub_num.tolist()}, roots occurring per view {occur}, the roots' "
            f"alpha peaks in view 0 (min / median / max; sweep 2 needs 0.8) "
            f"{root_alpha_peaks(tr)}, stage-2.2 "
            f"loss mean {float(s22.mean()):.6f}, steps with a loss {int((s22 > 0).sum())} of "
            f"{len(s22)}")
        if not np.isfinite(losses).all() or not m[3] < m[0]:
            raise AssertionError(f"{what}: losses {m}")
        pc = os.path.join(out, "point_cloud")
        a, b = (load_gaussian_ply(os.path.join(pc, f"iteration_{it}", "point_cloud.ply"))
                for it in (STAGE_ENDS["start_ins_feat_iter"], TRAIN_ITERS))
        if any(not np.array_equal(a[k], b[k]) for k in ("means", "log_scales", "quats")) or \
                not np.abs(a["ins_feat"] - b["ins_feat"]).max() > 0:
            raise AssertionError(f"{what}: the feature stages moved the geometry, or not "
                                 f"ins_feat")
        n_alive = tr._num_alive()
        for book in ("root_code_book", "leaf_code_book"):
            _c, ids = load_codebook(os.path.join(pc, f"iteration_{TRAIN_ITERS}", book))
            if len(ids) != n_alive:
                raise AssertionError(f"{what}: {book} has {len(ids)} ids for {n_alive}")
        z = np.load(os.path.join(out, "cluster_lang.npz"))
        if len(z["leaf_ind"]) != n_alive or z["leaf_feat"].shape != (
                o.root_node_num * o.leaf_node_num, 512):
            raise AssertionError(f"{what}: cluster_lang.npz {z['leaf_feat'].shape}")
        if not os.path.exists(os.path.join(out, "refine_trace", "summary.json")):
            raise AssertionError(f"{what}: no refine_trace/")
        st, adam, stats, kms, it = checkpoint.load(os.path.join(out, f"chkpnt{TRAIN_ITERS}.npz"),
                                                   dev)
        bad = [f.name for f in dataclasses.fields(st)
               if not torch.equal(getattr(st, f.name), getattr(tr.state, f.name))]
        bad += [k for k in adam.mu if not torch.equal(adam.mu[k], tr.adam.mu[k])]
        if it != TRAIN_ITERS or bad or not torch.equal(kms.leaf_cls_ids, tr.kms.leaf_cls_ids):
            raise AssertionError(f"{what}: the checkpoint does not reload bit for bit: {bad}")

        # one sharded step of each stage against the single-device step
        state, b0, bg = tr.state, tr.bundle, tr.bg
        cam0, pf = b0.camera(0), tr.pseudo.feat
        params = list(state.params())
        sweep_ok = [(r, v) for v in range(V) for r in range(o.root_node_num)
                    if bool(tr.pseudo.cluster_occur[v, r])]
        members = torch.bincount(tr.kms.cls_ids[state.alive].long(),
                                 minlength=o.root_node_num)
        tries = sweep_ok + [(int(r), v) for r in torch.argsort(members, descending=True)[:8]
                            for v in range(V)]
        live = None
        for r, v in tries:  # a root whose render occurs in the view
            res = loop.stage22_step(state, tr.adam, tr.kms, b0, v, STEP_ITS["2.2"], bg, 1.0,
                                    pf[v], r, True, tr.rcfg, o)
            if bool(res[3]):
                live = (r, v)
                break
        if live is None:
            raise AssertionError(f"{what}: no root renders with alpha above 0.8 in any view")
        r22, v22 = live
        log(f"{what}: stage-2.2 holds on root {r22} in view {v22} ("
            + ("sweep 2 passes it there" if live in sweep_ok else
               "sweep 2 passes no root: its render occurs, root_visible given True") + ")")
        errs, hold_launches, turns = {}, dict.fromkeys(launches, 0), {}
        for lay, extra in LAYOUTS.items():
            cfg = dataclasses.replace(tr.rcfg, **extra)
            steps = make_sharded_steps(mesh, cfg, o, tr.spatial_lr_scale)
            pairs = _stage_pairs(steps, loop, tr, cfg, (r22, v22))
            for stage, (sharded, single) in pairs.items():
                if stage == "0" and lay != "stream":
                    continue  # phase 9 holds stage 0 in every configuration
                zero_launches()
                got = sharded()
                for k, w in wrappers.items():
                    hold_launches[k] += w.launches
                errs[f"stage {stage}, {lay}"] = _hold_step(f"stage {stage}, {lay}", got,
                                                           single(), params)
                if lay == "stream":
                    turns[stage] = [cuda_ms(f, iters=5) for f in (single, sharded, sharded,
                                                                  single)]
            if lay == "stream":
                with torch.no_grad():
                    img, alpha, depth = steps.eval_render(state, cam0, bg)
                    ref = render(cam0, state, bg, 3, cfg)
                errs["eval_render"] = max(
                    compare(f"eval_render {k}, world 1", x, y, TOL["atol"], TOL["rtol"])
                    for k, x, y in (("image", img, ref.render), ("alpha", alpha, ref.alpha),
                                    ("depth", depth, ref.depth)))
        log(f"launches, the mesh trainer's sharded holds: {hold_launches}")
        if not all(hold_launches[k] for k in ("blend_stream_fwd", "blend_stream_bwd",
                                              "blend_stream_bwd_compact", "segment_reduce",
                                              "blend_tiles_fwd", "blend_tiles_bwd")):
            raise AssertionError(f"{what}: a kernel of the sharded holds never launched")

        # the sweeps and the stage-3 association, per view, against one device
        fns, k1, k2, M = tr._sweeps(), o.root_node_num, o.leaf_node_num, b0.max_masks
        sweep_t = {"sweep1": [], "sweep2": [], "stage3": []}
        for v in range(V):
            cam, sam, pids = b0.camera(v), b0.sam_ids[v], tr.pseudo.mask_ids[v]
            occ_row = tr.pseudo.cluster_occur[v]
            calls = {
                "sweep1": (lambda: fns.sweep1(state, cam, sam, bg),
                           lambda: pseudo._sweep1_view(state, cam, sam, bg, M, tr.rcfg)),
                "sweep2": (lambda: fns.sweep2(state, cam, pf[v], pids, tr.kms.cls_ids, bg),
                           lambda: pseudo._sweep2_view(state, cam, pf[v], pids, tr.kms.cls_ids,
                                                       bg, M, k1, tr.rcfg)),
                "stage3": (lambda: fns.lang_view(state, tr.kms.leaf_cls_ids, cam, pf[v], pids,
                                                 occ_row, bg),
                           lambda: lang._associate_view(state, tr.kms.leaf_cls_ids, cam, pf[v],
                                                        pids, occ_row, bg, k1, k2, M,
                                                        tr.rcfg))}
            for name, (sharded, single) in calls.items():
                got, want = sharded(), single()
                if name == "sweep1":
                    errs[f"sweep 1, view {v}"] = compare(
                        f"sharded sweep 1 features, view {v}", got[0], want[0], TOL["atol"],
                        TOL["rtol"])
                    same = torch.equal(got[1], want[1])
                elif name == "sweep2":
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                else:
                    same = torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                    errs[f"stage 3 scores, view {v}"] = compare(
                        f"sharded stage-3 scores, view {v}", got[1], want[1], 1e-4, 0.0)
                if not same:
                    raise AssertionError(f"{what}: sharded {name} of view {v} differs: {got} "
                                         f"against {want}")
                if v == 0:
                    sweep_t[name] = [cuda_ms(f, iters=1) for f in (single, sharded, sharded,
                                                                   single)]

        # the sharded refiner against one device on the two-blob scene
        st_r, cams_r, sam_r, cfg_r = refiner_two_blobs()
        st_r = to_device(st_r, dev)
        got = sr.refine_sam_masks(st_r, cams_r, sam_r, cfg_r, anchor_stride=1,
                                  sharded_fns=make_refiner_fns(mesh, cfg_r))
        want_ids = sr.refine_sam_masks(st_r, cams_r, sam_r, cfg_r, anchor_stride=1)
        if not np.array_equal(got, want_ids) or not (want_ids > 0).any():
            raise AssertionError(f"{what}: the sharded refiner's ids differ in "
                                 f"{int((got != want_ids).sum())} pixels")

        # the group entry of K5 at a tile offset: view 0's dense block from
        # tile t0 on, the first five roots' opacities, against its plain version
        with torch.no_grad():
            dcfg = dataclasses.replace(tr.rcfg, pallas_input="dense")
            cov = build_cov3d(state.scales, state.quats)
            proj, bins, (gx, gy) = _prepare(cam0, state.means, cov, state.opacity, dcfg)
            t0_off = (gx * gy) // 2
            bins = _tile_slice(bins, t0_off, gx * gy - t0_off)
            full_pay = torch.cat([(state.normalized_ins_feat() + 1.0) / 2.0,
                                  proj.depth[:, None]], dim=-1)
            gdata = gather_rows(proj.mean2d, proj.conic, state.opacity, full_pay,
                                bins.gauss_idx)
            keep = tr.kms.cls_ids[None, :] == torch.arange(5, device=dev)[:, None]
            opac_g = torch.where(keep & state.alive & proj.valid, state.opacity, 0.0)
            args = (gdata, bins.gauss_idx, opac_g.contiguous(), bins.counts, gx, chunk, t0_off)
            ka, kt = rk.blend_tiles_fwd_groups(*args)
            pa, pt = rk.blend_tiles_fwd_groups_plain(*args)
        k5_offset_err = max(float((ka - pa).abs().max()), float((kt - pt).abs().max()))
        if not (torch.equal(ka, pa) and torch.equal(kt, pt)):
            raise AssertionError(f"{what}: the group entry of K5 at tile offset {t0_off} "
                                 f"differs from its plain version")
        log(f"{what}: the group entry of K5 at tile offset {t0_off} ({gx * gy - t0_off} tiles, "
            f"G = 5, C = 7) bit for bit with its plain version")
    finally:
        dist.destroy_process_group()
    log(f"{what}: holds on the trained state, largest errors (tolerances: a step's loss 1e-5 "
        f"relative and its state {MESH_TOL} normalised; images atol {TOL['atol']} + rtol "
        f"{TOL['rtol']}; stage-3 scores 1e-4; sweep 2 and the ids equal) "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f"; the sharded refiner's ids equal the single-device refiner's; step ms in turns "
        f"single, sharded, sharded, single: "
        + "; ".join(f"stage {k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in turns.items())
        + "; view 0 ms in turns single, sharded, sharded, single: "
        + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in sweep_t.items())
        + f" [{card}]; more than one GPU: not measured (one card)")
    return dict(launches=launches, hold_launches=hold_launches, errs=errs, turns=turns,
                sweep_t=sweep_t, occur=occur, s22=float(s22.mean()), seconds=seconds,
                live=live in sweep_ok, k5_offset_err=k5_offset_err)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="another checkout of this repository (the parent commit): time "
                         "its K2, K4 and K6 beside this tree's, in turns, on the same "
                         "inputs; may be given more than once")
    opts = ap.parse_args(argv)
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
        if (line.startswith("==") or "registers" in line or "spill" in line
                or "entry function" in line):
            log(f"build: {line.strip()}")
    prks = {path: load_parent_kernels(path) for path in opts.parent}

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
            f"GB), {int(block[1].sum())} live rows, n_truncated {block[5]}")
        if block[5] != 0:
            raise AssertionError("the fitted max_per_tile truncated a tile")
        dense = check_dense_kernels(block, streams[7], cam0, grids, sam.sam_ids[0],
                                    sam.max_masks, chunk, state.capacity)
        check_against_oracle(dev)
        check_step_against_cpu(dev)
        check_feature_steps_against_cpu(dev)
        partition_err = check_partition_against_scan(cam0, state, dev)
        check_stage22_against_cpu(dev)
        refiner_errs = {lay: check_refiner_against_cpu(dev, lay) for lay in ("stream", "dense")}

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
        train_launches, s22_ms, leaf_ms, train_s = {}, {}, {}, {}
        for run, rcfg in runs.items():
            tr_r, train_launches[run], out_r, train_s[run] = train_path(scene_dir, root, dev,
                                                                        run, rcfg)
            if run == "stream":
                tr, out = tr_r, out_r
                check_trained_render(out, scene_dir, dev)
                # 6. queries: selection, evaluation and the viewer on this model
                queries = queries_path(out, scene_dir, root, dev, card)
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
        # the SAM refiner before stage 1, on host-resident, lazily loaded views
        tr_l, train_launches["lazy_refine"], out_l, _ = train_path(
            scene_dir, root, dev, "lazy_refine", RasterizeConfig(),
            ("--enable_multiview_sam_refinement", "--lazy_load"))
        l_s, l_r = float(tr.losses[0]), float(tr_l.losses[0])
        if not tr_l.save_memory or not math.isclose(l_r, l_s, rel_tol=1e-5):
            raise AssertionError(f"first loss: lazy_refine run {l_r!r}, stream {l_s!r}, "
                                 f"save_memory {tr_l.save_memory}")
        log(f"training path: first loss {l_r:.7f} (lazy_refine) and {l_s:.7f} (stream)")
        refined_run = check_refined_run(tr_l, out_l, card)
        view_steps = [time_view_steps(t, card, nm) for nm, t in (
            ("stream", tr), ("lazy_refine", tr_l), ("lazy_refine", tr_l), ("stream", tr))]
        del tr_l
        # the JAX package's options for fixed shapes, as a user switches them on:
        # fixed budgets, frozen plans and captured blocks of steps
        tr_b, train_launches["blocked"], out_b, train_s["blocked"] = train_path(
            scene_dir, root, dev, "blocked", RasterizeConfig(), trainer=blocked_trainer)
        blocked = check_blocked_run(tr_b, out_b, tr, out, train_s, card)
        # the refiner's fused path at the ScanNet shape
        refine = refine_phase(dev, card)

        # 7. timings
        k_ms, p_ms, k1_dev = {}, {}, {}
        with torch.no_grad():
            flush = torch.empty(2**26, dtype=torch.float32, device=dev)  # 256 MB > L2
            f_ms = cuda_ms(flush.zero_, iters=10)
            for C, (rows, counts, tstart, toff, gx, *_r) in streams.items():
                k1 = lambda: rk.blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)  # noqa: E731
                k_ms[C] = cuda_ms(k1, iters=20, warmup=3)
                cold = cuda_ms(lambda: (flush.zero_(), k1()), iters=10) - f_ms
                k1_dev[C] = device_ms(k1, 10, "blend_stream_fwd_kernel")
                p_ms[C] = cuda_ms(lambda: rk.blend_stream_fwd_plain(
                    rows, counts, tstart, toff, gx, chunk), iters=2)
                log(f"timing: blend_stream_fwd C={C}: kernel {k_ms[C]:.4f} ms/launch "
                    f"({cold:.4f} with L2 flushed; device time {k1_dev[C]:.4f}), plain "
                    f"{p_ms[C]:.3f} ms/launch, evaluated pairs {work[C]['evaluated']}, in "
                    f"box {work[C]['in_box']} [{card}]")
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
            R4 = compact["d"].shape[0]
            tail_fill = cuda_ms(lambda: torch.full((R4,), n, dtype=torch.int32, device=dev),
                                iters=20, warmup=3)
            log(f"timing: blend_stream_bwd_compact C=4: kernel {k4_ms:.4f} ms/launch "
                f"({k4_cold:.4f} with L2 flushed), plain {k4_plain:.3f} ms/launch, "
                f"{R4} compacted rows, {compact['nc_rows']} of them in the tiles' range "
                f"(the kernel writes the other rows' ids; a torch.full of all {R4} ids "
                f"would take {tail_fill:.4f} ms) [{card}]")
            k2f = lambda: rk.blend_stream_bwd(*bargs)  # noqa: E731
            k2_dev = device_ms(k2f, 10, "blend_stream_bwd_kernel")
            k4_dev = device_ms(lambda: rk.blend_stream_bwd_compact(*cargs), 10,
                               "blend_stream_bwd_compact_kernel")
            log(f"timing: device time by torch.profiler, C=4 frame: K2 kernel {k2_dev:.4f} ms "
                f"K4 kernel {k4_dev:.4f} ms per launch "
                f"(the calls above add the wrappers' host work: K2's zero fill of d_rows, "
                f"K4's chunk offsets on the card, no host sync) [{card}]")
            k2k3 = lambda: rk.segment_reduce(rk.blend_stream_bwd(*bargs), ids, n)  # noqa: E731
            k4k3 = lambda: rk.segment_reduce(*rk.blend_stream_bwd_compact(*cargs), n)  # noqa: E731
            pair = [cuda_ms(f, iters=20, warmup=3) for f in (k2k3, k4k3, k4k3, k2k3)]
            log(f"timing: backward + reduce, C=4 frame, in turns K2+K3, K4+K3, K4+K3, K2+K3: "
                + ", ".join(f"{x:.4f}" for x in pair) + " ms (K2's wrapper zero-fills d_rows, "
                f"K4's computes the chunk offsets on the card) [{card}]")
            k3 = lambda: rk.segment_reduce(d_rows, ids, n)  # noqa: E731
            k3_plain = cuda_ms(lambda: rk.segment_reduce_plain(d_rows, ids, n), iters=5)
            ids64 = ids.to(torch.int64)
            lib = lambda: torch.zeros((n, d_rows.shape[1]), device=dev).index_add_(  # noqa: E731
                0, ids64, d_rows)
            turns = [cuda_ms(f, iters=100, warmup=10) for f in (k3, lib, lib, k3)]
            k3_ms = (turns[0] + turns[3]) / 2
            k3_dev = device_ms(k3, 10, "segment_reduce_vec", "Memset")
            k3_kernel = device_ms(k3, 10, "segment_reduce_vec")
            lib_dev = device_ms(lib, 10)
            # what holds K3: the same launch with every row zero (reads, no
            # atomics) and with every id dropped (the id reads alone)
            zero_rows, dropped = torch.zeros_like(d_rows), torch.full_like(ids, n)
            k3_reads = device_ms(lambda: rk.segment_reduce(zero_rows, ids, n), 10,
                                 "segment_reduce_vec")
            k3_ids = device_ms(lambda: rk.segment_reduce(d_rows, dropped, n), 10,
                               "segment_reduce_vec")
            live_rows = int((d_rows != 0).any(dim=1).sum())
            log(f"timing: segment_reduce kernel {k3_kernel:.4f} ms with {live_rows} of "
                f"{d_rows.shape[0]} rows non-zero; the same rows all zero (reads, no "
                f"atomics) {k3_reads:.4f} ms; every id dropped (id reads only) "
                f"{k3_ids:.4f} ms [{card}]")
            log(f"timing: segment_reduce, {d_rows.shape[0]} rows x {d_rows.shape[1]} fields "
                f"into {n} splats, in turns K3 call, library (zeros + index_add_), library, "
                f"K3 call: " + ", ".join(f"{x:.4f}" for x in turns) + f" ms; device time by "
                f"torch.profiler: K3 {k3_dev:.4f} ms (kernel {k3_kernel:.4f}, the rest its "
                f"zero fill), library {lib_dev:.4f} ms; plain {k3_plain:.4f} ms [{card}]")
            # K5 and K6 on the dense block of phase 3
            gdata, dcounts, dstart, dgauss, gx, _ = block
            T, K, F = gdata.shape
            P7 = dgauss.shape[0]
            k5 = lambda: rk.blend_tiles_fwd(gdata, dcounts, gx, chunk)  # noqa: E731
            k5_ms = cuda_ms(k5, iters=20, warmup=3)
            k5_cold = cuda_ms(lambda: (flush.zero_(), k5()), iters=10) - f_ms
            k5_dev = device_ms(k5, 10, "blend_tiles_fwd_kernel")
            acc5, tf5 = k5()
            k5_plain = cuda_ms(lambda: rk.blend_tiles_fwd_plain(gdata, dcounts, gx, chunk),
                               iters=2)
            log(f"timing: blend_tiles_fwd C={F - 6}: kernel {k5_ms:.4f} ms/launch "
                f"({k5_cold:.4f} with L2 flushed; device time {k5_dev:.4f}), plain "
                f"{k5_plain:.3f} ms/launch, evaluated pairs {dense['work_fwd']['evaluated']}, "
                f"in box {dense['work_fwd']['in_box']} [{card}]")
            b6 = (gdata, dcounts, dstart, P7, acc5, tf5, *dense["cot"], gx, chunk)
            k6 = lambda: rk.blend_tiles_bwd(*b6)  # noqa: E731
            k6_ms = cuda_ms(k6, iters=20, warmup=3)
            k6_cold = cuda_ms(lambda: (flush.zero_(), k6()), iters=10) - f_ms
            k6_dev = device_ms(k6, 10, "blend_tiles_bwd_kernel")
            k6_plain = cuda_ms(lambda: rk.blend_tiles_bwd_plain(*b6), iters=2)
            fill_ms = cuda_ms(lambda: torch.zeros((P7, F), device=dev), iters=20, warmup=3)
            log(f"timing: blend_tiles_bwd C={F - 6}: kernel {k6_ms:.4f} ms/launch "
                f"({k6_cold:.4f} with L2 flushed; device time {k6_dev:.4f}; the zero fill "
                f"of its [{P7}, {F}] output, {P7 * F * 4 / 1e6:.1f} MB, in the call takes "
                f"{fill_ms:.4f} ms), plain {k6_plain:.3f} ms/launch, composited pairs "
                f"{dense['work_bwd']['blended']} [{card}]")
            # the three backwards with their reduce on the C = 7 feature pass:
            # K2 and K4 on its stream, K6 on the block gathered from it
            rows7, counts7, tstart7, toff7, _, bins7, _ = streams[7]
            b2 = (rows7, counts7, tstart7, toff7, acc5, tf5, *dense["cot"], gx, chunk)
            b4 = (rows7, counts7, tstart7, toff7, dgauss, acc5, tf5, *dense["cot"], gx,
                  chunk, n)
            three = {"K2+K3": lambda: rk.segment_reduce(rk.blend_stream_bwd(*b2), dgauss, n),
                     "K4+K3": lambda: rk.segment_reduce(*rk.blend_stream_bwd_compact(*b4), n),
                     "K6+K3": lambda: rk.segment_reduce(k6(), dgauss, n)}
            order = list(three) + list(three)[::-1]
            bwd3 = [cuda_ms(three[k], iters=20, warmup=3) for k in order]
            log(f"timing: backward + reduce, C={F - 6} frame (stage-1 cotangents), in turns "
                + ", ".join(f"{k} {x:.4f}" for k, x in zip(order, bwd3)) + f" ms [{card}]")
            cargs4 = (rows, counts, tstart, toff, ids, *cot, gx, chunk, n)
            for path, prk in prks.items():
                log(f"parent tree {path}, render frame:")
                time_against_parent(prk, {
                    "blend_stream_bwd C=4": ("blend_stream_bwd_kernel",
                                             lambda: rk.blend_stream_bwd(*bargs),
                                             lambda: prk.blend_stream_bwd(*bargs)),
                    "blend_stream_bwd_compact C=4": (
                        "blend_stream_bwd_compact_kernel",
                        lambda: rk.blend_stream_bwd_compact(*cargs4),
                        lambda: prk.blend_stream_bwd_compact(*cargs4)),
                    f"blend_tiles_bwd C={F - 6}": (
                        "blend_tiles_bwd_kernel", k6,
                        parent_k6(prk, gdata, dcounts, dstart, P7, acc5, tf5, *dense["cot"],
                                  gx, chunk))}, card)
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
        train = time_train_frame(tr, chunk, card, peak_flops, peak_bytes, prks)
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
        k4_b, k4_by = compact_bound(int(counts.sum()), compact["nc_rows"],
                                    compact["d"].shape[0], rows.shape[1], counts.shape[0],
                                    grad["work"], peak_flops, peak_bytes)
        log(f"bound: blend_stream_bwd_compact C=4: {k4_b:.4f} ms/launch ({k4_by}), kernel "
            f"(device time) at {k4_b / k4_dev:.3f} of it, the call at {k4_b / k4_ms:.3f} "
            f"[{card}]")
        k3_b, k3_by = reduce_bound(d_rows, n, peak_flops, peak_bytes)
        log(f"bound: segment_reduce: {k3_b:.4f} ms/launch ({k3_by}), kernel (device time, "
            f"its zero fill included) at {k3_b / k3_dev:.3f} of it, the call at "
            f"{k3_b / k3_ms:.3f} [{card}]")
        live = int(dcounts.sum())
        k5_b, k5_by = fwd_bound(f"blend_tiles_fwd C={F - 6}", live, F, T, 1,
                                dense["work_fwd"], peak_flops, peak_bytes)
        log(f"bound: blend_tiles_fwd C={F - 6}: {k5_b:.4f} ms/launch ({k5_by}), kernel at "
            f"{k5_b / k5_ms:.3f} of it [{card}]")
        k6_b, k6_by = bwd_bound(f"blend_tiles_bwd C={F - 6}", live, F, T, 2,
                                dense["work_bwd"], peak_flops, peak_bytes)
        log(f"bound: blend_tiles_bwd C={F - 6}: {k6_b:.4f} ms/launch ({k6_by}), kernel "
            f"(device time) at {k6_b / k6_dev:.3f} of it, the call at {k6_b / k6_ms:.3f} "
            f"[{card}]")

        # 8. fixed budgets, frozen plans, captured steps and dense group renders
        blob = check_blob_steps(dev, root)
        tuned = budgets_phase(tr, card)
        frozen = frozen_phase(tr, tuned, card)
        captured = captured_phase(tr, tuned, card)
        groups = dense_groups_phase(tr, tr_b, chunk, card)

        # 9. tile windows, tile bands and the mesh at world size 1
        windows = windows_phase(tr, chunk, card)
        bands = bands_phase(state, views[0].camera, tr, k_dense, card)
        meshed = mesh_phase(tr, windows["flat_cfg"], card)

        # 10. the mesh trainer at world size 1 on NCCL
        meshtr = mesh_trainer_phase(scene_dir, root, dev, chunk, card)

    k1_b = [b for b, _ in k1_bound.values()]

    def row(name, launches, err, ms, plain, bound, by, lib=None, line=None):
        return {"name": name, "route": "cuda",
                "source": f"opengaussian_tpu_torch/csrc/{name}.cu",
                "replaces": f"opengaussian_tpu/ops/rasterize_pallas.py:{line}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": lib}

    main_paths = (render_launches, *train_launches.values(), *queries["launches"].values(),
                  refine["launches"], groups["launches"], windows["launches"],
                  bands["launches"], meshed["launches"], meshtr["launches"],
                  meshtr["hold_launches"])
    total = {k: sum(p[k] for p in main_paths) for k in render_launches}
    log(f"launches on the main paths: render {render_launches}, "
        + ", ".join(f"training ({r}) {v}" for r, v in train_launches.items()) + ", "
        + ", ".join(f"{q} {v}" for q, v in queries["launches"].items())
        + f", refiner {refine['launches']}, dense groups {groups['launches']}, windows "
        f"{windows['launches']}, bands {bands['launches']}, mesh {meshed['launches']}, "
        f"mesh trainer {meshtr['launches']}, its sharded holds {meshtr['hold_launches']}")
    for k, kname, render_dev in (("k1", "K1", k1_dev), ("k2", "K2", {4: k2_dev}),
                                 ("k4", "K4", {4: k4_dev}), ("k6", "K6", {7: k6_dev})):
        t = train[k]
        log(f"summary: {kname} on the training frame: kernel {t['dev']:.4f} ms against a "
            f"{t['bound']:.4f} ms bound ({t['by']}), the deepest tile alone "
            f"{t['deep_dev']:.4f} ms; on the render frame "
            + ", ".join(f"C={C} {v:.4f} ms" for C, v in render_dev.items()) + f" [{card}]")
    log(f"summary: stage-2.2 step ms {s22_ms}; sweep 2 / stage 3 ms per view {leaf_ms}; "
        f"partition against scan max abs err {partition_err:.3e} [{card}]")
    log(f"summary: refiner: {REFINE_VIEWS} views {REFINE_W}x{REFINE_H}, {REFINE_SPLATS} "
        f"splats: {refine['total_s']:.3f} s, n_gids {refine['n_gids']}, void fraction "
        f"{refine['void']:.4f}, the refiner's own peak device memory "
        f"{refine['peak'] / 2**30:.3f} GiB, view 0's "
        f"votes {refine['votes_ms']:.3f} ms and expansion {refine['expand_ms']:.3f} ms device "
        f"time; in the lazy_refine training run {refined_run['seconds']:.3f} s (n_gids "
        f"{refined_run['n_gids']}); card against CPU, two blobs: "
        + ", ".join(f"{lay} votes {e['votes']:.2e} weights {e['weights']:.2e}"
                    for lay, e in refiner_errs.items())
        + "; stage-0 / stage-1 step ms in turns stream, lazy_refine, lazy_refine, stream: "
        + ", ".join(f"{v['0']:.3f} / {v['1']:.3f}" for v in view_steps) + f" [{card}]")
    log(f"summary: queries: render_selection {queries['sel_ms']:.3f} ms, LPIPS "
        f"{queries['lp_ms']:.3f} ms per view, viewer frame {queries['frame_ms']:.3f} ms; "
        f"card against CPU at 160x120, largest normalised error "
        f"{max(queries['errors'].values()):.3e} [{card}]")
    log(f"summary: fixed shapes: blob trainer captured against eager "
        + "; ".join(f"{lay} " + ", ".join(f"{s} {e:.1e}" for s, e in errs.items())
                    for lay, errs in blob.items())
        + f"; full width tuned P = {tuned.intersection_budget}, K = {tuned.max_per_tile}; "
        f"frozen plans {frozen['build_ms']:.3f} ms, {frozen['mib']:.1f} MiB; blocked run "
        f"geometry bit for bit with the stream run at iteration 40: {blocked['bitwise']} [{card}]")
    for (lay, stage), r in captured.items():
        log(f"summary: stage-{stage} step ({lay}) eager / captured: ms {r['eager'][0]:.3f} / "
            f"{r['captured'][0]:.3f}, busy {r['eager'][1]:.3f} / {r['captured'][1]:.3f}, idle "
            f"share {r['eager'][2]:.3f} / {r['captured'][2]:.3f}, kernels per step "
            f"{r['eager'][3]} / {r['captured'][3]}, captured against eager {r['err']:.1e} "
            f"[{card}]")
    log(f"summary: dense groups: group entries bit for bit at G = 1, 5; sweep 2 / stage 3 "
        f"ms per view stream {leaf_ms['stream']['sweep2']:.3f} / "
        f"{leaf_ms['stream']['stage3']:.3f}, dense layout {leaf_ms['dense']['sweep2']:.3f} / "
        f"{leaf_ms['dense']['stage3']:.3f}, dense groups {groups['leaf_ms']['sweep2']:.3f} / "
        f"{groups['leaf_ms']['stage3']:.3f} [{card}]")
    w_t = windows["times"]
    log(f"summary: windows: S = {windows['S']}, K = {windows['win_cfg'].max_per_tile}, Tv = "
        f"{windows['Tv']} for {windows['band']} tiles ({windows['dead']} dead); K1, K2, K4 "
        f"bit for bit on the virtual tiles; folded against unwindowed "
        + ", ".join(f"{k} {v:.2e}" for k, v in windows["fold_err"].items())
        + "; device ms windowed / unwindowed (the means of two turns): "
        + ", ".join(f"{k} {(v[0] + v[3]) / 2:.4f} / {(v[1] + v[2]) / 2:.4f}"
                    for k, v in w_t.items() if len(v) == 4)
        + f", K1 deepest tile alone {w_t['K1 deepest alone'][0]:.4f} / "
        f"{w_t['K1 deepest alone'][1]:.4f}; the fold {windows['fold_dev']:.4f}; stage-1 step "
        f"eager {sum(windows['eager_ms']['windowed']) / 2:.3f} / "
        f"{sum(windows['eager_ms']['unwindowed']) / 2:.3f} ms, captured "
        f"{sum(windows['cap_ms']['windowed']) / 2:.3f} / "
        f"{sum(windows['cap_ms']['unwindowed']) / 2:.3f} ms [{card}]")
    log(f"summary: bands: rasterize_banded(bands=4) against rasterize, image / gradient "
        + ", ".join(f"{f.split(' C=')[0]} {lay} {e:.1e} / {g:.1e}"
                    for (f, lay), (e, g) in bands["errs"].items())
        + "; mesh at world size 1: render_sharded "
        + ", ".join(f"{k} {e:.1e}" for k, (e, _g) in meshed["errs"].items())
        + f", {MESH_STEPS} stage-0 steps within {meshed['state_err']:.1e}, scaling_bench "
        f"{meshed['scaling']} [{card}]")
    log(f"summary: mesh trainer at world size 1: {TRAIN_ITERS} iterations through cli.train "
        f"--mesh 1 in {meshtr['seconds']:.2f} s, roots occurring per view {meshtr['occur']}, "
        f"stage-2.2 loss mean {meshtr['s22']:.6f} (the stage-2.2 hold's root "
        + ("passes" if meshtr["live"] else "occurs, but sweep 2 passes no root") + "); "
        + ", ".join(f"{k} {e:.1e}" for k, e in meshtr["errs"].items())
        + "; step ms single / sharded (the means of two turns) "
        + ", ".join(f"stage {k} {(v[0] + v[3]) / 2:.3f} / {(v[1] + v[2]) / 2:.3f}"
                    for k, v in meshtr["turns"].items())
        + "; view 0 ms single / sharded "
        + ", ".join(f"{k} {(v[0] + v[3]) / 2:.3f} / {(v[1] + v[2]) / 2:.3f}"
                    for k, v in meshtr["sweep_t"].items()) + f" [{card}]")
    kernels = [
        row("blend_stream_fwd", total["blend_stream_fwd"],
            max(k1_err, train["k1"]["err"], refine["k1_err"], windows["k1_err"]),
            sum(k_ms.values()) / len(k_ms), sum(p_ms.values()) / len(p_ms),
            sum(k1_b) / len(k1_b), max(k1_bound.values())[1], line=562),
        row("blend_stream_bwd", total["blend_stream_bwd"],
            max(grad["k2_err"], train["k2"]["err"], windows["k2_err"]), k2_ms, k2_plain,
            k2_b, k2_by, line=670),
        row("blend_stream_bwd_compact", total["blend_stream_bwd_compact"],
            max(compact["k4_err"], train["k4"]["err"], windows["k4_err"]), k4_dev, k4_plain,
            k4_b, k4_by,
            line=841),
        row("segment_reduce", total["segment_reduce"],
            max(grad["k3_err"], dense["k3_err"], compact["k43_err"], windows["k3_err"]),
            k3_dev, k3_plain, k3_b, k3_by, lib=lib_dev, line=1196),
        row("blend_tiles_fwd", total["blend_tiles_fwd"] + total["blend_tiles_fwd_groups"],
            max(dense["k5_err"], *groups["errs"].values(), meshtr["k5_offset_err"]), k5_ms,
            k5_plain, k5_b, k5_by,
            line=322),
        row("blend_tiles_bwd", total["blend_tiles_bwd"] + total["blend_tiles_bwd_groups"],
            max(dense["k6_err"], train["k6"]["err"], *groups["errs"].values()), k6_ms,
            k6_plain, k6_b, k6_by, line=413),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
