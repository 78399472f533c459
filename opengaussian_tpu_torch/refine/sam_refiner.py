"""Multi-view SAM mask refinement (the fork's subsystem).

Port of opengaussian_tpu/refine/sam_refiner.py, which rewrites the
reference's MultiViewSAMMaskRefiner (reference
utils/sam_refinement_utils.py:320-1318, SURVEY.md §3.4):

  stage 0: per-camera depth maps; a splat is visible in a camera when its
    projected center is in-frustum, in front, and within 15 cm of the
    rendered depth (sam_refinement_utils.py:526-651);
  stage 1 (ID sync): anchor splats (opacity >= 0.99, strided) vote the
    dominant SAM id inside their footprint in every visible camera; each
    anchor mints a global id unifying its per-view winners
    (sam_refinement_utils.py:902-913, 1055-1115);
  stage 2 (mask expansion): every splat votes its dominant global id per
    camera; the winner is the camera-majority id; in cameras where the
    per-view dominant equals the winner, base-mask pixels take the 1.0 init
    plus +1 per contributing splat while footprint weights accumulate on
    EXTENSION pixels only; the refined mask is the per-pixel argmax with
    weight < 0.5 -> -1 (sam_refinement_utils.py:915-942, 1221-1302).

The per-splat vote (splat x id) and the per-pixel accumulation (pixel x id)
cover every splat of a camera at once through the tile binning: per chunk
of each tile's slots, the raw footprint alphas [T, chunk, 256] contract with
one-hot ids in one fp32 batched matrix product, so a camera costs about one
render. The depth render is the rasterizer's (one K1 launch per view in the
stream layout, K5 in the dense one); the votes and the expansion are plain
PyTorch, as the JAX package computes them in XLA outside any Pallas kernel.
The votes' scatter-add (`add_votes`) follows RasterizeConfig.reduce_backend:
under "sorted_mxu" (the default) K3's sorted entry adds each splat's votes
in row order, as the CPU's `index_add_` does, so the votes repeat from run
to run; under "scatter" it is `index_add_`, whose order on the card is
atomic. Votes and weights agree with the CPU's to a tolerance (the card's
matrix products round otherwise), and the masks agree where no decision is
near a tie. The host graph merge and `majority_winner`
are the JAX package's numpy, unchanged.

Both footprint passes project without opacities (the classic 3-sigma rect,
no opacity-aware cull radius) and bin densely at config.max_per_tile, as the
JAX package's `_prepare(..., None, force_dense=True)`: those tiles can be
deeper than a max_per_tile fitted to the tight binning, and are truncated
at it in both packages alike.

Under a device mesh (`refine_sam_masks(sharded_fns=...)`, from
parallel/refine.py:make_refiner_fns) the three device passes run with the
state sharded, and `_host` gathers the splat vectors the host merge reads;
every rank then runs the merge alike.

Documented deviations from the reference (tests/test_refiner_golden.py pins
everything else):
  * the void id (-1 / here 0) never votes and is never expanded;
  * stage-1 id sync merges TRANSITIVELY: an anchor adopting an
    already-claimed (view, id) pair links its remaining pairs into that
    global id, where the reference's first-claim sync (:1096-1112) leaves
    them under a fresh id;
  * vote ties across cameras break toward the earliest camera (reference
    dict-insertion max), and within a view's weighted bincount toward the
    smallest id.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import GaussianState
from opengaussian_tpu_torch.ops import blend
from opengaussian_tpu_torch.ops import rasterize_kernels as rk
from opengaussian_tpu_torch.ops.projection import TILE, build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, _prepare, rasterize

DEPTH_THRESHOLD = 0.15  # meters (sam_refinement_utils.py:628)
ANCHOR_OPACITY = 0.99  # stage-1 anchor gate (:1159-1204)
ANCHOR_STRIDE = 1000
EXPANSION_THRESHOLD = 0.5  # final per-pixel weight gate (:1287-1302)


def _host(x: torch.Tensor, mesh=None) -> np.ndarray:
    """x on the host; under a mesh (x this rank's rows) the whole table's,
    gathered: the graph merge reads every splat's opacity and aliveness on
    every rank. Every rank must call it."""
    if mesh is not None:
        from opengaussian_tpu_torch.parallel.mesh import all_gather

        x = all_gather(x, mesh)
    return x.cpu().numpy()


@contextlib.contextmanager
def fp32_matmuls():
    """Matrix products in float32 (TF32 off) inside the block; the caller's
    setting comes back after it. The votes and weights feed argmaxes, hard
    decisions that TF32's 10-bit mantissa would move."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def add_votes(votes: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
              live: torch.Tensor, config: RasterizeConfig) -> torch.Tensor:
    """votes [N, M] += rows [R, M] by splat ids [R], in place: under
    reduce_backend "sorted_mxu" through K3's sorted entry (each splat's rows
    in row order, from its value in votes: index_add_'s order, so the sums
    repeat; the rows that are not live, all zero, left out, so the padding
    of every tile's chunk is no run of id 0), under "scatter" by index_add_
    (atomic order on the card)."""
    if not config.fixed_reduce_order():
        return votes.index_add_(0, ids, rows)
    n = votes.shape[0]
    return rk.segment_reduce_sorted(rows.contiguous(), torch.where(live, ids, n).to(torch.int32),
                                    n, out=votes)


def _tile_pixels(grid_x: int, grid_y: int, dev) -> torch.Tensor:
    """[T, 256, 2] float pixel coordinates (x, y) of every tile's pixels."""
    t = torch.arange(grid_x * grid_y, device=dev)
    lane = torch.arange(TILE * TILE, device=dev)
    px = ((t % grid_x) * TILE)[:, None] + (lane % TILE)[None, :]
    py = ((t // grid_x) * TILE)[:, None] + (lane // TILE)[None, :]
    return torch.stack([px, py], dim=-1).to(torch.float32)


def _footprint_bins(gs: GaussianState, camera: Camera, config: RasterizeConfig):
    """Projection without opacities and the dense binning at
    config.max_per_tile. -> (proj, bins, (grid_x, grid_y), pix [T, 256, 2])."""
    cov3d = build_cov3d(gs.scales, gs.quats)
    proj, bins, grids = _prepare(camera, gs.means, cov3d, None,
                                 dataclasses.replace(config, pallas_input="dense"))
    return proj, bins, grids, _tile_pixels(*grids, gs.device)


def _chunk_alphas(proj, bins, opac, pix, config: RasterizeConfig):
    """Per chunk of every tile's slots: (ids [T, chunk] int64, raw alpha
    [T, chunk, 256] with no 0.99 clamp, 1/255 skip or transmittance, live
    [T, chunk] bool); slots past a tile's count (not live) have id 0 and
    opacity 0."""
    chunk = config.chunk
    k = torch.arange(chunk, device=pix.device)
    for i in range(config.max_per_tile // chunk):
        ids = bins.gauss_idx[:, i * chunk:(i + 1) * chunk].to(torch.int64)
        kmask = (i * chunk + k)[None, :] < bins.counts[:, None]
        o = torch.where(kmask, opac[ids], 0.0)
        yield ids, blend.alpha_from_conic(proj.mean2d[ids], proj.conic[ids], o, pix), kmask


def _tile_sam_onehot(sam_ids, grid_x: int, grid_y: int, max_ids: int) -> torch.Tensor:
    """[H, W] ids -> [T, 256, M] one-hot (id 0 = invalid excluded)."""
    H, W = sam_ids.shape
    s = torch.nn.functional.pad(sam_ids, (0, grid_x * TILE - W, 0, grid_y * TILE - H))
    s = s.reshape(grid_y, TILE, grid_x, TILE).permute(0, 2, 1, 3)
    s = s.reshape(grid_y * grid_x, TILE * TILE)
    ids = torch.arange(1, max_ids + 1, dtype=s.dtype, device=s.device)
    return (s[:, :, None] == ids[None, None, :]).to(torch.float32)


@torch.no_grad()
@fp32_matmuls()
def splat_id_votes(gs: GaussianState, camera: Camera, sam_ids: torch.Tensor,
                   depth_map: torch.Tensor, max_ids: int, config: RasterizeConfig):
    """sam_ids [H, W] (0 invalid), depth_map [H, W] expected depth of the
    full render. -> (votes [N, M] footprint-weighted id histogram per splat,
    visible [N] bool depth-tested visibility)."""
    camera = camera.to(gs.device)
    proj, bins, (grid_x, grid_y), pix = _footprint_bins(gs, camera, config)

    # stage-0 visibility: in frustum + depth agreement at the projected center
    H, W = camera.height, camera.width
    cx = torch.clamp(proj.mean2d[:, 0].to(torch.int32), 0, W - 1).to(torch.int64)
    cy = torch.clamp(proj.mean2d[:, 1].to(torch.int32), 0, H - 1).to(torch.int64)
    visible = proj.valid & ((proj.depth - depth_map[cy, cx]).abs() < DEPTH_THRESHOLD)

    onehot = _tile_sam_onehot(sam_ids, grid_x, grid_y, max_ids)  # [T, 256, M]
    opac = torch.where(proj.valid & gs.alive, gs.opacity, 0.0)
    votes = torch.zeros((gs.capacity, max_ids), dtype=torch.float32, device=gs.device)
    for ids, alpha, live in _chunk_alphas(proj, bins, opac, pix, config):
        v_chunk = torch.bmm(alpha, onehot)  # tkp,tpm->tkm
        add_votes(votes, ids.reshape(-1), v_chunk.reshape(-1, max_ids), live.reshape(-1),
                  config)
    return votes, visible


@torch.no_grad()
@fp32_matmuls()
def pixel_weight_accumulation(gs: GaussianState, camera: Camera,
                              splat_global_id: torch.Tensor, contrib: torch.Tensor,
                              synced_mask: torch.Tensor, n_match: torch.Tensor,
                              max_ids: int, config: RasterizeConfig) -> torch.Tensor:
    """Stage-2 accumulation with the reference's semantics
    (sam_refinement_utils.py:928-940 init, :1022-1035 base/extension split):

      weights[p, g] = 1 + n_match[g]                         where base[p, g]
                      sum_{contributing splats of g} alpha    elsewhere

    base[p, g] = (synced_mask[p] == g): base-mask pixels get the 1.0 init
    plus +1 per contributing splat; footprint alpha lands only on EXTENSION
    pixels (outside the winner's base mask). splat_global_id [N] int (0 =
    unassigned, 1..M), contrib [N] bool (visible and the per-view dominant
    equals the winner), synced_mask [H, W] per-pixel global id (0 = void),
    n_match [M] contributing splats per id. -> [H, W, M] float32."""
    camera = camera.to(gs.device)
    proj, bins, (grid_x, grid_y), pix = _footprint_bins(gs, camera, config)
    opac = torch.where(proj.valid & gs.alive & contrib & (splat_global_id > 0),
                       gs.opacity, 0.0)
    ids_m = torch.arange(1, max_ids + 1, device=gs.device)
    T = bins.counts.shape[0]
    acc = torch.zeros((T, TILE * TILE, max_ids), dtype=torch.float32, device=gs.device)
    for ids, alpha, _live in _chunk_alphas(proj, bins, opac, pix, config):
        onehot = (splat_global_id[ids][:, :, None] == ids_m).to(torch.float32)
        acc.baddbmm_(alpha.transpose(1, 2), onehot)  # += tkp,tkm->tpm
    H, W = camera.height, camera.width
    acc = acc.reshape(grid_y, grid_x, TILE, TILE, max_ids).permute(0, 2, 1, 3, 4)
    acc = acc.reshape(grid_y * TILE, grid_x * TILE, max_ids)[:H, :W]
    # the JAX package's base * (1 + n_match) + (1 - base) * acc, bit for bit
    # (acc is finite), without its three [H, W, M] temporaries
    base = synced_mask[:, :, None] == ids_m
    return torch.where(base, 1.0 + n_match, acc)


def pixel_weight_expand(gs, camera, splat_global_id, contrib, synced_mask, n_match,
                        max_ids: int, config: RasterizeConfig,
                        threshold: float) -> torch.Tensor:
    """pixel_weight_accumulation and the per-pixel argmax and threshold on
    the device: the [H, W, n_gids] weight volume never leaves it, only the
    [H, W] winners do. -> refined row [H, W] int32 (-1 void), the caller's
    where(wmax >= threshold, argmax + 1, -1)."""
    return _expand(pixel_weight_accumulation(gs, camera, splat_global_id, contrib,
                                             synced_mask, n_match, max_ids, config),
                   threshold)


def _expand(w: torch.Tensor, threshold: float) -> torch.Tensor:
    """Weights [H, W, M] -> the refined row [H, W] int32: where(max weight >=
    threshold, argmax + 1, -1)."""
    best = torch.argmax(w, dim=-1).to(torch.int32)
    wmax = torch.amax(w, dim=-1)
    return torch.where(wmax >= threshold, best + 1, -1)


def majority_winner(dom: np.ndarray) -> np.ndarray:
    """Per-splat MAJORITY over per-view dominant ids, 0 = no vote (reference
    expand_masks:1005-1020 counts one vote per camera; max() over the
    insertion-ordered dict returns the EARLIEST camera's id on ties).

    O(V log V * N): run lengths over column-sorted dominants pick the mode;
    the rare multi-way ties fall back to the exact insertion-order scan on
    just the tied columns. dom: [V, N] int."""
    V, n = dom.shape
    ds = np.sort(dom, axis=0)  # [V, N] ascending, zeros first
    run = np.ones((V, n), np.int64)
    for v in range(1, V):
        same = (ds[v] == ds[v - 1]) & (ds[v] > 0)
        run[v] = np.where(same, run[v - 1] + 1, 1)
    run = np.where(ds > 0, run, 0)
    best_row = run.argmax(axis=0)
    best_cnt = np.take_along_axis(run, best_row[None], axis=0)[0]
    winner = np.where(
        best_cnt > 0, np.take_along_axis(ds, best_row[None], axis=0)[0], 0
    ).astype(np.int32)
    n_max_runs = (run == np.maximum(best_cnt, 1)[None, :]).sum(axis=0)
    tied = (best_cnt > 0) & (n_max_runs > 1)
    if tied.any():
        cols = np.flatnonzero(tied)
        bc = np.zeros(len(cols), np.int64)
        sg = np.zeros(len(cols), np.int32)
        sub = dom[:, cols]
        for v in range(V):
            c = sub[v]
            cnt_v = ((sub == c[None, :]) & (c[None, :] > 0)).sum(axis=0)
            better = cnt_v > bc
            bc = np.where(better, cnt_v, bc)
            sg = np.where(better, c, sg)
        winner[cols] = sg
    return winner


@torch.no_grad()
def refine_sam_masks(
    gs: GaussianState,
    cameras: list[Camera],
    sam_ids: np.ndarray,  # [V, H, W] per-view level-decoded ids (0 invalid)
    config: RasterizeConfig = RasterizeConfig(),
    anchor_stride: int = ANCHOR_STRIDE,
    trace=None,  # refine/introspect.RefinerTrace, or None
    timings: dict | None = None,  # phase wall seconds, accumulated
    sharded_fns=None,  # parallel/refine.py:make_refiner_fns(...)
) -> np.ndarray:
    """-> refined [V, H, W] cross-view-consistent ids (-1 void, like the
    reference's final masks). The device passes run on gs's device; each
    ends in a copy to the host, so `timings` charges each phase its own
    device time: device_votes_s (depth render and votes), host_stage1_merge_s,
    host_dominant_s, host_majority_s, host_expand_prep_s, device_expand_s
    and, with a trace, host_expand_argmax_s. sharded_fns: under a mesh, the
    sharded device passes, with which gs is this rank's shard; every rank
    calls this alike, each with a trace or none."""

    def _mark(phase, t0):
        if timings is not None:
            timings[phase] = timings.get(phase, 0.0) + (time.perf_counter() - t0)
        return time.perf_counter()

    _t = time.perf_counter()
    V = len(cameras)
    max_ids = int(sam_ids.max())
    if max_ids == 0:
        return np.where(sam_ids > 0, sam_ids, -1)
    dev = gs.device
    mesh = sharded_fns.mesh if sharded_fns is not None else None
    if trace is not None:
        trace.log_scene(_host(gs.means, mesh), _host(gs.alive, mesh))

    # per-camera depth maps + per-splat votes/visibility
    cov3d = build_cov3d(gs.scales, gs.quats)
    votes_all, vis_all = [], []
    for v in range(V):
        sam_v = torch.as_tensor(sam_ids[v], device=dev)
        if sharded_fns is not None:
            votes, vis, depth = sharded_fns.depth_votes(gs, cameras[v], sam_v, max_ids)
        else:
            out = rasterize(cameras[v], gs.means, cov3d, gs.opacity,
                            torch.zeros((gs.capacity, 1), device=dev),
                            torch.zeros(1, device=dev), config)
            depth = out.depth / torch.clamp(out.alpha, min=1e-6)
            votes, vis = splat_id_votes(gs, cameras[v], sam_v, depth, max_ids, config)
        votes_all.append(votes.cpu().numpy())
        vis_all.append(vis.cpu().numpy())
        if trace is not None:
            trace.log_depth(v, depth.cpu().numpy(), vis_all[-1])
    votes_all = np.stack(votes_all)  # [V, N, M]
    vis_all = np.stack(vis_all)  # [V, N]
    _t = _mark("device_votes_s", _t)

    # stage 1: global id sync via anchor splats (host graph merge). The
    # per-anchor winners come from ONE vectorized argmax pass ([V, A]
    # scalars), so the merge loop only touches scalars.
    opac = _host(gs.opacity, mesh)
    anchors = np.flatnonzero((opac >= ANCHOR_OPACITY) & _host(gs.alive, mesh))
    anchors = anchors[::anchor_stride] if len(anchors) else anchors
    win_lid = np.zeros((V, len(anchors)), np.int32)  # 0 = no winner
    if len(anchors):
        va = votes_all[:, anchors]  # [V, A, M]
        has = (va.max(axis=2) > 0) & vis_all[:, anchors]
        win_lid = np.where(has, va.argmax(axis=2) + 1, 0).astype(np.int32)
    # per (view, local id) -> global id mapping
    local2global = np.zeros((V, max_ids + 1), np.int32)
    next_gid = 1
    for ai in range(len(anchors)):
        gid = 0
        for v in range(V):
            lid = win_lid[v, ai]
            if lid == 0:
                continue
            if local2global[v, lid] > 0:
                gid = gid or int(local2global[v, lid])
            else:
                if gid == 0:
                    gid = next_gid
                    next_gid += 1
                local2global[v, lid] = gid
    # unseen local ids keep their own fresh global ids (per-view np.unique)
    for v in range(V):
        present = np.unique(sam_ids[v])
        present = present[(present >= 1) & (present <= max_ids)]
        fresh = present[local2global[v, present] == 0]
        local2global[v, fresh] = next_gid + np.arange(len(fresh), dtype=np.int32)
        next_gid += len(fresh)
    n_gids = next_gid - 1
    if trace is not None:
        trace.log_stage1(anchors, win_lid, local2global, n_gids)
    _t = _mark("host_stage1_merge_s", _t)

    # per-view dominant GLOBAL id per splat (footprint-weighted vote within
    # each view, reference get_most_common_id_in_mask_weighted:653-703, with
    # the local->global remap summing columns that the sync merged). The
    # reduction stays in LOCAL column space ([N, M]); the merge-summed
    # columns are grouped by np.add.reduceat over gid-sorted columns.
    n = votes_all.shape[1]  # the whole table's splats
    dom = np.zeros((V, n), np.int32)  # 0 = no vote in this view
    for v in range(V):
        cols = local2global[v][1:]  # global id of local ids 1..M
        keep_idx = np.flatnonzero(cols > 0)
        if len(keep_idx) == 0:
            continue
        order = keep_idx[np.argsort(cols[keep_idx], kind="stable")]
        gids_sorted = cols[order]
        starts = np.flatnonzero(
            np.concatenate([[True], gids_sorted[1:] != gids_sorted[:-1]])
        )
        group_gid = gids_sorted[starts]  # [G_v] distinct global ids
        vred = np.add.reduceat(votes_all[v][:, order], starts, axis=1)
        has = (vred.max(axis=1) > 0) & vis_all[v]
        # ties: argmax picks the first gid-sorted group (the smallest id)
        dom[v] = np.where(has, group_gid[vred.argmax(axis=1)], 0)
    _t = _mark("host_dominant_s", _t)
    splat_gid = majority_winner(dom)
    _t = _mark("host_majority_s", _t)

    # stage 2: per-camera expansion + argmax. A splat contributes to camera v
    # only where its per-view dominant id equals its global winner
    # (reference expand_masks:1021-1035).
    refined = np.full_like(sam_ids, -1, dtype=np.int64)
    gid_t = torch.as_tensor(splat_gid, device=dev)
    for v in range(V):
        match_v = (dom[v] == splat_gid) & (splat_gid > 0)
        n_match = np.bincount(splat_gid[match_v],
                              minlength=n_gids + 1)[1:].astype(np.float32)
        synced_v = local2global[v][sam_ids[v]].astype(np.int32)
        args = (gs, cameras[v], gid_t, torch.as_tensor(match_v, device=dev),
                torch.as_tensor(synced_v, device=dev),
                torch.as_tensor(n_match, device=dev), n_gids)
        _t = _mark("host_expand_prep_s", _t)
        weights = (sharded_fns.pixel_weights(*args) if sharded_fns is not None
                   else None)
        if trace is None:
            # fused device argmax: only the [H, W] winners leave the device
            row = (pixel_weight_expand(*args, config, EXPANSION_THRESHOLD)
                   if weights is None else _expand(weights, EXPANSION_THRESHOLD))
            refined[v] = row.cpu().numpy()
            _t = _mark("device_expand_s", _t)
            continue
        if weights is None:
            weights = pixel_weight_accumulation(*args, config)
        wnp = weights.cpu().numpy()
        _t = _mark("device_expand_s", _t)
        best = wnp.argmax(axis=-1)
        wmax = wnp.max(axis=-1)
        refined[v] = np.where(wmax >= EXPANSION_THRESHOLD, best + 1, -1)
        trace.log_stage2(v, dom[v], splat_gid, wnp)
        _t = _mark("host_expand_argmax_s", _t)
    if trace is not None:
        trace.write(refined)
    return refined
