"""The SAM refiner's wall time at the ScanNet shape, split into its device
passes and its host phases (the port's counterpart of the JAX repo's
tools/refine_bench.py).

    python -m opengaussian_tpu_torch.tools.refine_bench [--splats 100000]
        [--views 60] [--ids 32] [--stride 1000]

The scene (`refine_scene`, tools/refine_bench.py's, built in numpy the same
way, so equal bit for bit): splats filling a room volume, about 40% of them
past the 0.99 anchor opacity (a trained scene's top end), cameras on an arc
at 648x484, and per view a blocky grid of SAM ids whose numbering shifts
from view to view (so that the refiner's first stage has cross-view work),
with an invalid border stripe. `run` refines it with
`refine_sam_masks(..., timings=)` and returns the JSON: the phase seconds,
`device_total_s`, `host_total_s`, `total_s`, `host_frac`, `refined_ids`,
`void_frac`, the workload and `device`, the card's name and power limit.
Before it times anything, `main` holds the refiner's kernels (K1's depth
render, K3's sorted entry for the votes) against their plain versions
(`check_kernels`). It runs at the JAX tool's
RasterizeConfig(max_per_tile=512, chunk=64), at which the refiner's 3-sigma
binning truncates the deepest tiles of this scene, as the JAX tool's does:
the figures are the reference's setting, not a fit. chip_smoke.py calls
`run` at a max_per_tile fitted to the binning's deepest tile. Prints the
JSON as its last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models import gaussians as G
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, deepest_tile, rasterize
from opengaussian_tpu_torch.refine.sam_refiner import refine_sam_masks, splat_id_votes
from opengaussian_tpu_torch.tools import bench, timing

WIDTH, HEIGHT = 648, 484
CHECK_SPLATS = 20_000  # the kernel check's scene


def refine_scene(n: int = 100_000, views: int = 60, ids: int = 32, device="cuda",
                 width: int | None = None, height: int | None = None):
    """tools/refine_bench.py:51-85's scene: n splats, `views` cameras at
    width x height (WIDTH x HEIGHT by default), `ids` SAM ids per view.
    -> (state, cameras, SAM ids [V, H, W] int16)."""
    W, H = width or WIDTH, height or HEIGHT
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.normal(0, 1.2, n), rng.normal(0, 0.9, n),
                    rng.uniform(2.0, 9.0, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    gs = G.create_from_pcd(pts, cols, capacity=n, seed=0, device=dev)
    op = np.where(rng.uniform(size=n) < 0.4, 6.0, rng.normal(0.0, 2.0, n))
    gs = dataclasses.replace(gs, log_scales=gs.log_scales + math.log(0.05),
                             logit_opacity=torch.as_tensor(op.astype(np.float32), device=dev))
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    gh = max(1, int(np.sqrt(ids / 2)))
    gw = max(1, ids // gh)
    block = ((yy * gh // H) * gw + (xx * gw // W)) % ids
    cams, sams = [], []
    for v in range(views):
        ang = 0.9 * (v / max(views - 1, 1) - 0.5)
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.array([0.8 * np.sin(2 * ang), 0.1 * np.cos(3 * ang), 0.0], np.float32)
        cams.append(Camera.from_fov(R, t, 1.1, 0.9, W, H))
        s = ((block + v * 7) % ids + 1).astype(np.int16)
        s[:6] = 0  # an invalid border stripe
        sams.append(s)
    return gs, cams, np.stack(sams)


def check_kernels(ids: int, width: int, height: int, device) -> float:
    """The refiner's kernels on the card against their plain versions,
    before any timing (`bench.hold_against_plain`): on the first view of
    this scene with CHECK_SPLATS splats, at a max_per_tile fitted to the
    view's deepest tile (nothing truncated), the depth render (K1: depth
    and alpha at bench.IMG_TOL normalised) and the footprint votes (K3's
    sorted entry, at bench.GRAD_TOL), both votes from the CPU's depth map.
    -> the largest error."""
    def depth_render(gs, cam, rcfg):
        r = rasterize(cam, gs.means, build_cov3d(gs.scales, gs.quats), gs.opacity,
                      torch.zeros((gs.capacity, 1), device=gs.device),
                      torch.zeros(1, device=gs.device), rcfg)
        return r.depth, r.alpha

    gs, cams, sam = refine_scene(CHECK_SPLATS, 1, ids, "cpu", width, height)
    chunk = RasterizeConfig().chunk
    with torch.no_grad():
        deep = deepest_tile(cams[0], gs.means, build_cov3d(gs.scales, gs.quats), None,
                            RasterizeConfig())
        rcfg = RasterizeConfig(max_per_tile=max(chunk, -(-deep // chunk) * chunk))
        depth, alpha = depth_render(gs, cams[0], rcfg)
    depth_map = depth / torch.clamp(alpha, min=1e-6)

    @torch.no_grad()
    def run(dev):
        g, c, _ = refine_scene(CHECK_SPLATS, 1, ids, dev, width, height)
        cam = c[0].to(dev)
        d, a = depth_render(g, cam, rcfg)
        votes, _ = splat_id_votes(g, cam, torch.as_tensor(sam[0], device=dev),
                                  depth_map.to(dev), int(sam.max()), rcfg)
        return {"depth": d, "alpha": a, "votes": votes}

    return bench.hold_against_plain(
        f"refiner kernel check ({width}x{height}, {CHECK_SPLATS} splats, K "
        f"{rcfg.max_per_tile})", run, device, bench.GRAD_TOL,
        {"depth": bench.IMG_TOL, "alpha": bench.IMG_TOL})


def run(gs, cameras, sam_ids: np.ndarray, rcfg: RasterizeConfig, stride: int,
        card: str = "cpu") -> tuple[dict, np.ndarray]:
    """Refine and time. -> (the JSON's dict, the refined ids [V, H, W])."""
    timings: dict = {}
    if gs.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = refine_sam_masks(gs, cameras, sam_ids, rcfg, anchor_stride=stride,
                               timings=timings)
    if gs.device.type == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    device = sum(v for k, v in timings.items() if k.startswith("device"))
    host = sum(v for k, v in timings.items() if k.startswith("host"))
    V, H, W = sam_ids.shape
    res = dict(
        workload=dict(splats=gs.capacity, views=V, width=W, height=H,
                      ids_per_view=int(sam_ids.max()), anchor_stride=stride,
                      max_per_tile=rcfg.max_per_tile),
        refined_ids=int(refined.max()),
        void_frac=round(float((refined < 0).mean()), 4),
        **{k: round(v, 3) for k, v in sorted(timings.items())},
        device_total_s=round(device, 3),
        host_total_s=round(host, 3),
        total_s=round(total, 3),
        host_frac=round(host / max(total, 1e-9), 3),
        device=card,
    )
    return res, refined


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splats", type=int, default=100_000)
    ap.add_argument("--views", type=int, default=60)
    ap.add_argument("--ids", type=int, default=32, help="SAM ids per view")
    ap.add_argument("--stride", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"
    check_kernels(args.ids, WIDTH, HEIGHT, dev)
    gs, cams, sam = refine_scene(args.splats, args.views, args.ids, dev)
    res, _ = run(gs, cams, sam, RasterizeConfig(max_per_tile=512, chunk=64), args.stride, card)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
