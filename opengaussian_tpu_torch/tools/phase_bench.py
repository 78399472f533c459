"""Where a forward+backward step's time goes, by timing its parts on the
card (the port's counterpart of the JAX repo's tools/phase_bench.py,
tools/bin_bisect.py and tools/micro_bench.py, folded into one tool).

    python -m opengaussian_tpu_torch.tools.phase_bench [--heavy] [--recipe]
        [--iters 20] [--reduce scatter|sorted_mxu] [--layout dense|compact]
        [--p 851968] [--n 200000] [--cols 10]

Before any timing, the step's kernels against their plain versions
(`bench.check_kernels`). Then three tables, each row timed by CUDA events
after a warm-up call, with the call's index folded into its inputs (no two
calls see the same inputs):
  * prefixes of the step on tools/bench.py's workload (--heavy: scale 0.15;
    --recipe: the ScanNet recipe's 648x484): `null` (one tiny kernel, the
    launch floor), `proj` (projection), `proj+bin` (and the binning),
    `fwd(kernel)` (and the row gather and K1, raw tile buffers), `fwd(+loss)`
    (the render and the L1 loss) and `fwd+bwd` (the bench's step); the
    successive differences approximate each part;
  * the binning's staged prefixes on the workload's projected splats at its
    tuned budget P, through ops/binning.py's own stages (`expand`:
    `expand_slots`, each slot's splat; `tileid`: `slot_tiles`, its tile and
    the circle cull; `sort`: `sort_slots`, the (tile, depth) key sort;
    `edges`: the tiles' runs; `full bin`: `bin_gaussians` itself);
  * the binning's sub-operations alone on synthetic data at --p slots,
    --n splats and a --cols-wide carry.
Prints the tables, then one JSON line with the three and `device`, the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.ops import binning
from opengaussian_tpu_torch.ops import rasterize_kernels as rk
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import _blend_inputs, _prepare, gather_rows
from opengaussian_tpu_torch.ops.sh import sh_to_rgb
from opengaussian_tpu_torch.render import render
from opengaussian_tpu_torch.tools import bench, timing
from opengaussian_tpu_torch.train import losses

RECIPE_W, RECIPE_H = 648, 484


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def perturb(gs, i: int):
    """gs with logit-opacity + 1e-6 i."""
    return dataclasses.replace(gs, logit_opacity=gs.logit_opacity + 1e-6 * i)


def timer(device, iters: int):
    """-> timed(name, fn, table): ms per call of fn(i), i the call index."""

    def timed(name: str, fn, table: dict) -> float:
        calls = iter(range(10 ** 9))
        table[name] = timing.step_ms(lambda: fn(next(calls)), iters, device)
        log(f"{name:<34} {table[name]:9.3f} ms")
        return table[name]

    return timed


def prefix_table(state, cam, rcfg, gt, bg, make_fwd_bwd, timed) -> dict:
    """The step's prefixes (module docstring)."""
    rows: dict = {}
    cov = lambda gs: build_cov3d(gs.scales, gs.quats)  # noqa: E731

    @torch.no_grad()
    def proj_only(i):
        gs = perturb(state, i)
        p = project(gs.means, cov(gs), cam, opacities=gs.opacity)
        return p.mean2d.sum(), p.conic.sum(), p.depth.sum(), p.num_tiles.sum()

    @torch.no_grad()
    def proj_bin(i):
        gs = perturb(state, i)
        _, bins, _ = _prepare(cam, gs.means, cov(gs), gs.opacity, rcfg, reduce_order=False)
        return bins.counts.sum(), bins.sorted_gauss.sum()

    @torch.no_grad()
    def fwd_kernel(i):
        gs = perturb(state, i)
        payload = sh_to_rgb(3, gs.sh, gs.means, cam.cam_center)
        proj, bins, (gx, _) = _prepare(cam, gs.means, cov(gs), gs.opacity, rcfg,
                                       reduce_order=False)
        opac, full = _blend_inputs(proj, gs.opacity, payload)
        rows = gather_rows(proj.mean2d, proj.conic, opac, full, bins.sorted_gauss)
        toff = torch.arange(bins.counts.shape[0], dtype=torch.int32, device=gs.device)
        accum, t_final = rk.blend_stream_fwd(rows, bins.counts, bins.tile_start, toff, gx,
                                             rcfg.chunk)
        return accum.sum(), t_final.sum()

    @torch.no_grad()
    def fwd(i):
        return losses.l1_loss(render(cam, perturb(state, i), bg, 3, rcfg).render, gt)

    step = make_fwd_bwd(rcfg)
    timed("null", lambda i: state.logit_opacity[0] + i, rows)
    timed("proj", proj_only, rows)
    timed("proj+bin", proj_bin, rows)
    timed("fwd(kernel)", fwd_kernel, rows)
    timed("fwd(+loss)", fwd, rows)
    timed("fwd+bwd", lambda i: step(perturb(state, i)), rows)
    return rows


def bisect_table(state, cam, rcfg, timed) -> dict:
    """ops/binning.py:bin_gaussians cut off after each of its stages
    (`expand_slots`, `slot_tiles`, `sort_slots`, the tiles' edges), on the
    workload's projected splats at its tuned P (module docstring)."""
    rows: dict = {}
    gx = (cam.width + TILE - 1) // TILE
    gy = (cam.height + TILE - 1) // TILE
    T = gx * gy
    P, K = rcfg.max_intersections(state.capacity), rcfg.max_per_tile
    cov3d = build_cov3d(state.scales, state.quats)

    def staged(stage: str):
        @torch.no_grad()
        def fn(i):
            proj = project(state.means, cov3d, cam, opacities=state.opacity * (1.0 + 1e-6 * i))
            n = proj.num_tiles.shape[0]
            g, slot, starts, _ends, live = binning.expand_slots(
                proj.num_tiles.to(torch.int64), P)
            if stage == "expand":
                return g.sum()
            tid, hits = binning.slot_tiles(proj, g, slot, starts, gx)
            tile_id = torch.where(hits & live, tid, T)
            if stage == "tileid":
                return tile_id.sum()
            rank = binning.depth_rank(proj.depth)
            tile_s, _order, g_sorted = binning.sort_slots(tile_id, rank, g, n)
            if stage == "sort":
                return tile_s.sum(), g_sorted.sum()
            edges = torch.searchsorted(tile_s, torch.arange(T + 1, device=tile_s.device))
            return torch.clamp(edges[1:] - edges[:-1], max=K).sum()
        return fn

    @torch.no_grad()
    def full_bin(i):
        proj = project(state.means, cov3d, cam, opacities=state.opacity * (1.0 + 1e-6 * i))
        bins = binning.bin_gaussians(proj, gx, gy, K, max_intersections=P)
        return bins.counts.sum(), bins.sorted_gauss.sum()

    for stage in ("expand", "tileid", "sort", "edges"):
        timed(f"proj+{stage}", staged(stage), rows)
    timed("proj+full bin", full_bin, rows)
    return rows


def micro_table(P: int, N: int, D: int, device, timed) -> dict:
    """The binning's sub-operations alone (module docstring), on synthetic
    data: ascending run-structured splat ids, random keys and depths."""
    rows: dict = {}
    rng = np.random.default_rng(0)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    ends = t(np.cumsum(rng.integers(0, 9, N)).astype(np.int64))
    slot = torch.arange(P, device=device)
    g = torch.clamp(torch.searchsorted(ends, slot, right=True), max=N - 1)
    table = t(rng.normal(size=(N, D)).astype(np.float32))
    key = t(rng.integers(0, 2 ** 40, P).astype(np.int64))
    depth = t(rng.normal(size=(N,)).astype(np.float32))
    fP = t(rng.normal(size=(P,)).astype(np.float32))
    cols = [t(rng.normal(size=(N,)).astype(np.float32)) for _ in range(D)]
    queries = torch.arange(5249, device=device)
    key_sorted = torch.sort(key).values
    with torch.no_grad():
        timed(f"searchsorted expansion [{N}]->[{P}]",
              lambda i: torch.searchsorted(ends + i, slot, right=True), rows)
        timed(f"cumsum [{N}]", lambda i: torch.cumsum(ends + i, 0), rows)
        timed(f"argsort depth [{N}] + rank scatter",
              lambda i: binning.depth_rank(depth + i), rows)
        timed(f"row gather [{N},{D}] -> [{P},{D}] (ascending ids)", lambda i: (table + i)[g],
              rows)
        timed(f"sort int64 key @ {P} (stable, with its order)",
              lambda i: torch.sort(key + i, stable=True), rows)
        timed(f"permute [{P}] int64 by the order", lambda i: (g + i)[torch.argsort(key)], rows)
        timed(f"10 elementwise passes over [{P}]",
              lambda i: sum(torch.sin(fP + j + i) for j in range(10)), rows)
        timed(f"cat {D}x[{N}] -> [{N},{D}]", lambda i: torch.stack([c + i for c in cols], -1),
              rows)
        timed(f"searchsorted 5249 queries @ {P}",
              lambda i: torch.searchsorted(key_sorted, queries + i), rows)
    return rows


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heavy", action="store_true")
    ap.add_argument("--recipe", action="store_true",
                    help="the ScanNet recipe's frame (648x484) instead of 1296x968")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reduce", default=None, help="override reduce_backend")
    ap.add_argument("--layout", default=None, help="override bwd_layout")
    ap.add_argument("--p", type=int, default=851968, help="micro table: slots")
    ap.add_argument("--n", type=int, default=200_000, help="micro table: splats")
    ap.add_argument("--cols", type=int, default=10,
                    help="micro table: carry width (mean2d 2, conic 3, opacity 1, rgb 3, "
                         "depth 1)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"
    size = dict(width=RECIPE_W, height=RECIPE_H) if args.recipe else {}
    scale = 0.15 if args.heavy else 0.088
    state, cam, rcfg, gt, bg, make_fwd_bwd = bench.make_workload(scale, device=dev, **size)
    if args.reduce:
        rcfg = dataclasses.replace(rcfg, reduce_backend=args.reduce)
    if args.layout:
        rcfg = dataclasses.replace(rcfg, bwd_layout=args.layout)
    workload = dict(scale=scale, width=cam.width, height=cam.height,
                    P=rcfg.max_intersections(state.capacity), K=rcfg.max_per_tile,
                    reduce=rcfg.resolved_reduce_backend(), layout=rcfg.bwd_layout)
    log(f"workload: {workload} [{card}]")
    bench.check_kernels(state, [rcfg])
    timed = timer(dev, args.iters)
    log("\nprefixes:")
    prefixes = prefix_table(state, cam, rcfg, gt, bg, make_fwd_bwd, timed)
    log("\nbinning, staged:")
    bisect = bisect_table(state, cam, rcfg, timer(dev, max(1, args.iters // 2)))
    del state
    log("\nbinning's sub-operations:")
    micro = micro_table(args.p, args.n, args.cols, dev, timer(dev, max(1, args.iters // 2)))
    total = prefixes["fwd+bwd"]
    mpix_s = cam.width * cam.height / total / 1e3
    log(f"\nfwd+bwd: {total:.3f} ms/step = {mpix_s:.2f} Mpix/s [{card}]")
    out = dict(workload=workload, prefixes=prefixes, bisect=bisect, micro=micro,
               fwd_bwd_mpix_s=mpix_s, device=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
