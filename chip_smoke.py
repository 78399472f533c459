"""Drive the PyTorch port (opengaussian_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); TF32 off.
  2. build: every CUDA kernel of the port, from the sources in the checkout.
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the streams of a full-width frame (1296x968, 200k splats, SH degree 3,
     6-D instance features), at C = 4 (RGB + depth) and C = 7 (features +
     depth); and the rasterizer on the card against the naive oracle on the
     CPU, on a small scene.
  4. main path: `opengaussian_tpu_torch.cli.render.main` renders a synthetic
     trained model (written as a PLY) of a 3-view COLMAP scene; checks the
     outputs and that each kernel ran on this path.
  5. timings (CUDA events after warm-up), each line with the card's name,
     and torch.profiler's device time by kernel over a render of each view,
     which gives the card's idle share during that profiled render.
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
TOL = dict(atol=3e-5, rtol=1e-4)
# fp32 operations per (slot, pixel) pair of the blend, by what the pair needs:
# every evaluated pair: dx, dy and the conic's quadratic form (11), the clamp
# of power (1), expf (~8: range reduction, ex2 and scaling without fast
# math), the power test, o * gauss, the 0.99 clamp and the 1/255 test (4)
OPS_EVALUATED = 24
OPS_TESTED = 3  # alpha >= 1/255: 1 - alpha, T * (1 - alpha), the 1e-4 test


def ops_blended(C: int) -> int:
    """A pair that composites: w = alpha * T, then a multiply-add per channel."""
    return 1 + 2 * C


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
    logit-opacities ~ N(0, 2)), SH degree 3 and seeded 6-D features."""
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
        imgs[i + 1] = colmap.ColmapImage(i + 1, q, np.zeros(3), 1, f"view_{i:03d}.png")
        im = np.stack([xx * 255 // WIDTH, yy * 255 // HEIGHT,
                       np.full_like(xx, 60 * i)], -1).astype(np.uint8)
        Image.fromarray(im).save(os.path.join(scene, "images", f"view_{i:03d}.png"))
        sam = np.zeros((4, HEIGHT, WIDTH), np.int16)
        sam[3] = (xx // 324 + 4 * (yy // 242)).astype(np.int16)
        np.save(os.path.join(scene, "language_features", f"view_{i:03d}_s.npy"), sam)
    colmap.write_cameras_binary(cams, os.path.join(scene, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(scene, "sparse/0/images.bin"))
    colmap.write_points3d_binary(pts[:1000].astype(np.float64),
                                 (cols[:1000] * 255).astype(np.uint8),
                                 os.path.join(scene, "sparse/0/points3D.bin"))
    return model, scene


def frame_streams(camera, state):
    """The blend inputs of one view's two render passes, built by the
    render path's own _prepare: {C: (rows, counts, tstart, toff, grid_x, bins)}."""
    from opengaussian_tpu_torch.ops.projection import build_cov3d
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _prepare
    from opengaussian_tpu_torch.ops.sh import sh_to_rgb
    from opengaussian_tpu_torch.render import encoded_ins_feat

    camera = camera.to(state.device)
    cov3d = build_cov3d(state.scales, state.quats)
    rgb = sh_to_rgb(3, state.sh, state.means, camera.cam_center)
    feat = encoded_ins_feat(state, origin_feat=True)
    out = {}
    for payload in (rgb, feat):
        _, bins, (gx, _) = _prepare(camera, state.means, cov3d, state.opacity,
                                    payload, RasterizeConfig())
        toff = torch.arange(bins.counts.shape[0], dtype=torch.int32,
                            device=state.device)
        out[payload.shape[1] + 1] = (bins.sorted_carry, bins.counts,
                                     bins.tile_start, toff, gx, bins)
    return out


def check_kernel_against_plain(streams, chunk: int) -> tuple[float, dict]:
    """blend_stream_fwd (CUDA) against blend_stream_fwd_plain at each C.
    -> (max abs error, {C: the plain version's work counts})."""
    from opengaussian_tpu_torch.ops.rasterize_kernels import (
        blend_stream_fwd,
        blend_stream_fwd_plain,
    )

    worst, work = 0.0, {}
    for C, (rows, counts, tstart, toff, gx, _) in streams.items():
        acc, t_final = blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)
        torch.cuda.synchronize()
        acc_p, t_p, work[C] = blend_stream_fwd_plain(rows, counts, tstart, toff, gx,
                                                     chunk, count_work=True)
        log(f"work C={C}: " + ", ".join(f"{k} {v}" for k, v in work[C].items()))
        for name, x, y in (("accum", acc, acc_p), ("t_final", t_final, t_p)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"C={C}: kernel {name} is not finite")
            err = (x - y).abs()
            bad = err > TOL["atol"] + TOL["rtol"] * y.abs()
            e = float(err.max())
            worst = max(worst, e)
            log(f"kernel blend_stream_fwd C={C} {name}: max_abs_err={e:.3e} "
                f"out_of_tol={int(bad.sum())}")
            if bool(bad.any()):
                i = int(torch.argmax(torch.where(bad, err, 0.0)))
                idx = np.unravel_index(i, tuple(x.shape))
                raise AssertionError(
                    f"C={C} {name} disagrees with the plain version at {idx}: "
                    f"kernel {float(x.flatten()[i])!r} plain {float(y.flatten()[i])!r}")
    return worst, work


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
    r = rasterize(cam, *(x.to(dev) for x in (means, cov, op, cols, bg)), cfg)
    o = rasterize_oracle(cam, means, cov, op, cols, bg)
    for k, x in (("image", r.image), ("alpha", r.alpha), ("depth", r.depth)):
        tol = dict(atol=3e-4, rtol=1e-4) if k == "depth" else TOL
        torch.testing.assert_close(x.cpu(), o[k], **tol, msg=lambda m: f"{k}: {m}")
    if not torch.equal(r.radii.cpu(), o["radii"]):
        raise AssertionError("radii disagree with the oracle")
    log(f"oracle: 160x120, {n} splats: image/alpha/depth/radii agree")


def bound_ms(streams, work, peak_flops, peak_bytes) -> tuple[dict, str]:
    """Least time of one launch at each C: the larger of the bytes moved over
    the HBM rate and the operations this stream's data needs (from the plain
    version's work counts) over the fp32 rate. -> ({C: ms}, what bounds the
    larger of them)."""
    bound, by = {}, {}
    for C, (rows, counts, *_rest) in streams.items():
        T = counts.shape[0]
        moved = (int(counts.sum()) * rows.shape[1] * 4  # each slot row read once
                 + 3 * T * 4  # counts, tstart, toff
                 + T * 256 * (C + 1) * 4)  # accum and t_final written once
        w = work[C]
        ops = (w["evaluated"] * OPS_EVALUATED + w["tested"] * OPS_TESTED
               + w["blended"] * ops_blended(C))
        t_bytes, t_ops = moved / peak_bytes * 1e3, ops / peak_flops * 1e3
        bound[C] = max(t_bytes, t_ops)
        by[C] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"bound: blend_stream_fwd C={C}: {moved} bytes -> {t_bytes:.4f} ms, "
            f"{ops} ops -> {t_ops:.4f} ms")
    return bound, by[max(bound, key=bound.get)]


def profile_render(views, state) -> tuple[float, float]:
    """torch.profiler over one render of every view: device time by kernel.
    -> (device busy ms per view, the union of the kernels' intervals; host
    wall ms per view of the same profiled renders, to the last kernel's end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render

    bg = torch.zeros(3, device=state.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in views:
            render(v.camera, state, bg, 3, RasterizeConfig(), render_color=True,
                   render_feat_map=True, origin_feat=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(views)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    busy_ms = busy / 1e3 / len(views)
    span_ms = (end - kernels[0].time_range.start) / 1e3 / len(views)
    log(f"profile: device busy {busy_ms:.3f} ms/view, first kernel start to last "
        f"kernel end {span_ms:.3f} ms/view, host wall {wall_ms:.3f} ms/view, "
        f"{len(kernels) / len(views):.0f} kernel launches/view")
    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"profile:   {us / 1e3 / len(views):8.4f} ms/view  {k[:90]}")
    return busy_ms, wall_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from opengaussian_tpu_torch.cli import render as cli_render
    from opengaussian_tpu_torch.data.dataset import load_scene
    from opengaussian_tpu_torch.models.loading import load_model
    from opengaussian_tpu_torch.ops import rasterize_kernels as rk
    from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
    from opengaussian_tpu_torch.render import render

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
    _, build_log = rk.build()
    log(f"build: blend_stream_fwd.cu in {time.perf_counter() - t0:.3f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
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
            max_err, work = check_kernel_against_plain(streams, chunk)
            check_against_oracle(dev)

        # 4. main path, through the CLI a user runs
        rk.blend_stream_fwd.launches = 0
        t0 = time.perf_counter()
        n_views = cli_render.main(["-m", model, "-s", scene_dir], device=dev)
        torch.cuda.synchronize()
        launches = rk.blend_stream_fwd.launches
        log(f"main path: {n_views} views in {time.perf_counter() - t0:.2f} s, "
            f"blend_stream_fwd launches={launches}")
        if n_views != N_VIEWS or launches != 2 * n_views:
            raise AssertionError(f"expected 2 x {N_VIEWS} launches, got {launches} "
                                 f"for {n_views} views")
        for split, nv in (("train", len(scene.train_views)), ("test", len(scene.test_views))):
            for sub in ("renders", "gt", "ins_feat1", "ins_feat2", "sam_mask"):
                d = os.path.join(model, split, "ours", sub)
                if sorted(os.listdir(d)) != [f"{i:05d}.png" for i in range(nv)]:
                    raise AssertionError(f"missing PNGs in {d}")
        with torch.no_grad():
            for i, v in enumerate(views):
                for C, (*_s, bins) in frame_streams(v.camera, state).items():
                    log(f"view {i} C={C}: slots={int(bins.counts.sum())} "
                        f"n_dropped={int(bins.n_dropped)} "
                        f"n_truncated={int(bins.n_truncated)} "
                        f"deepest_tile={int(bins.deepest)}")
                    if int(bins.n_dropped) != 0:
                        raise AssertionError("n_dropped must be 0")
                out = render(v.camera, state, torch.zeros(3, device=dev), 3,
                             RasterizeConfig(), render_color=True,
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

        # 5. timings
        with torch.no_grad():
            k_ms, p_ms = {}, {}
            flush = torch.empty(2**26, dtype=torch.float32, device=dev)  # 256 MB > L2
            f_ms = cuda_ms(flush.zero_, iters=10)
            for C, (rows, counts, tstart, toff, gx, _) in streams.items():
                k1 = lambda: rk.blend_stream_fwd(rows, counts, tstart, toff, gx, chunk)  # noqa: E731
                k_ms[C] = cuda_ms(k1, iters=20, warmup=3)
                cold = cuda_ms(lambda: (flush.zero_(), k1()), iters=10) - f_ms
                p_ms[C] = cuda_ms(lambda: rk.blend_stream_fwd_plain(
                    rows, counts, tstart, toff, gx, chunk), iters=2)
                log(f"timing: blend_stream_fwd C={C}: kernel {k_ms[C]:.4f} ms/launch "
                    f"({cold:.4f} with L2 flushed), plain {p_ms[C]:.3f} ms/launch, "
                    f"evaluated pairs {work[C]['evaluated']} [{card}]")
            bg = torch.zeros(3, device=dev)
            r_ms = cuda_ms(lambda: [render(v.camera, state, bg, 3, RasterizeConfig(),
                                           render_color=True, render_feat_map=True,
                                           origin_feat=True) for v in views],
                           iters=3) / len(views)
            log(f"timing: render {r_ms:.3f} ms/view (color + feature pass) [{card}]")
            s_ms = cuda_ms(lambda: frame_streams(views[0].camera, state), iters=3)
            log(f"timing: SH + feature encode + project + bin, both passes "
                f"{s_ms:.3f} ms/view [{card}]")
            log("timing: library_ms null: no single PyTorch call computes a "
                "depth-ordered alpha blend with early stop")
            busy, wall = profile_render(views, state)
            log(f"timing: device idle share during the profiled render "
                f"{1.0 - busy / wall:.3f} (busy {busy:.3f} of {wall:.3f} ms/view, "
                f"both from that run) [{card}]")
        bound, b_by = bound_ms(streams, work, peak_flops, peak_bytes)
        for C, b in bound.items():
            log(f"bound: blend_stream_fwd C={C}: {b:.4f} ms/launch ({b_by}), "
                f"kernel at {b / k_ms[C]:.3f} of it [{card}]")
        b_ms = sum(bound.values()) / len(bound)

    kernels = [{
        "name": "blend_stream_fwd", "route": "cuda",
        "source": "opengaussian_tpu_torch/csrc/blend_stream_fwd.cu",
        "replaces": "opengaussian_tpu/ops/rasterize_pallas.py:562",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(k_ms.values()) / len(k_ms), "plain_ms": sum(p_ms.values()) / len(p_ms),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
