"""Differentiable tile rasterizer (port of opengaussian_tpu/ops/rasterize.py).

project -> bin (sorted slot stream) -> per-tile blend -> untile. Any
C-channel payload composites in one pass, with depth appended as one more
channel. The blend takes one of two input layouts, as in the JAX package
(`RasterizeConfig.pallas_input`):
  * "stream" (default): `StreamBlend`, the counterpart of the custom VJP
    `rasterize_pallas.py:blend_tiles_pallas_stream`. Its forward launches
    `rasterize_kernels.blend_stream_fwd` (K1) on the sorted slot rows. Its
    backward launches `blend_stream_bwd` (K2, per-slot gradient rows at the
    stream positions) or, with `bwd_layout="compact"`,
    `blend_stream_bwd_compact` (K4, the same rows compacted by chunk with
    their splat ids), and then K3, the per-splat sums.
  * "dense": `DenseBlend`, the counterpart of the custom VJP
    `blend_tiles_pallas`. Its forward gathers a [T, K, 6 + C] block and
    launches `blend_tiles_fwd` (K5), its backward `blend_tiles_bwd` (K6,
    the live rows at their stream positions, as K2 gives them) and then K3
    over those rows.
All give the same images and gradients. On the CPU each kernel runs its
plain PyTorch version.

K3 sums per splat in the order `RasterizeConfig.reduce_backend` names, as
in the JAX package, whose "auto" means "sorted_mxu" (`REDUCE_BACKEND`):
  * "sorted_mxu": a fixed order, so a step's gradients repeat bit for bit
    from run to run. The binning returns its sort's inverse permutation and
    each splat's range of expanded slots (`TileBins.slot_pos`,
    `splat_end`), and `segment_reduce_perm` sums each splat's rows in that
    order, which is the order of its slots in the stream: no sort, where
    the JAX package sorts the rows by id (and caches the sort for frozen
    geometry in its ReducePlan, as `FrozenPlan` caches this order). The
    compact backward's rows take it through `compact_positions`, the group
    renders' per group;
  * "scatter": `segment_reduce`'s atomic adds, in an order that changes from
    run to run (the JAX package's segment_sum).

Group renders (stage 2.2, the pseudo-label sweeps, stage 3) render G subsets
of one scene: `rasterize_scan_groups` re-bins each group with its own masked
opacities under one shared projection and depth rank (any layout, with
gradients), under the group budgets of `RasterizeConfig.group_config`;
`rasterize_partition` renders G disjoint groups with one binning over G x T
virtual tiles and one K1 launch (stream layout); `rasterize_groups`
(group_render="dense") bins the union once, densely, and blends it once per
group with the group entries of K5 and K6 (`GroupDenseBlend`).

Budgets (`RasterizeConfig.intersection_budget` and friends, sized by
ops/budget.py) fix the slot stream's length P, as the JAX package's static
budgets do: no step then reads a count back to the host, and slots past P
are dropped and counted in `n_dropped`. With the budget 0 (the default) the
stream is sized per frame and nothing is dropped, where the JAX package
would drop the slots past 8N: that is the port's one deviation from it.
A `FrozenPlan` (`build_frozen_plan`) caches a view's binning for frozen
geometry, so that a step's whole binning is one row gather.

Two more options of the JAX package, both off by default:
  * tile windows (`RasterizeConfig.tile_windows` S > 0, stream layout):
    binning splits a tile deeper than max_per_tile into up to S virtual
    tiles, K1 blends each as a tile of its own, and `_fold_windows` composes
    a tile's windows in plain differentiable torch, so the backward kernels
    receive per-window cotangents through autograd and need no window
    logic;
  * tile bands: `rasterize_banded` bins and blends the frame in horizontal
    bands of tile rows (K1 or K5 with the band's tile offset), and the
    sharded render of parallel/render.py bins each rank's band of the
    gathered table (`band_intersection_budget`).

Gradients by means3d, cov3d, opacities, payload and the screen tap flow
through `project` by ordinary autograd; only the blend has its own backward.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops.binning import TileBins, bin_gaussians, depth_rank
from opengaussian_tpu_torch.ops.projection import TILE, Projected, project
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    N_GEOM,
    blend_stream_bwd,
    blend_stream_bwd_compact,
    blend_stream_fwd,
    blend_tiles_bwd,
    blend_tiles_bwd_groups,
    blend_tiles_fwd,
    blend_tiles_fwd_groups,
    compact_positions,
    segment_reduce,
    segment_reduce_perm,
)
from opengaussian_tpu_torch.utils.trace import (
    BIN,
    BLEND,
    BLEND_BWD,
    GEOMETRY,
    REDUCE,
    span,
    spanned,
)

LAYOUTS = ("stream", "dense")
BWD_LAYOUTS = ("auto", "dense", "compact")
GROUP_RENDERS = ("auto", "scan", "dense")
REDUCE_BACKENDS = ("auto", "sorted_mxu", "scatter")
# what reduce_backend "auto" means (the JAX package's
# rasterize_pallas.REDUCE_BACKEND): the per-splat reduce in the binning's
# fixed order
REDUCE_BACKEND = "sorted_mxu"


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer settings the port reads (same defaults as the JAX
    package's RasterizeConfig)."""

    max_per_tile: int = 1024  # K: depth-ordered slots kept per tile
    chunk: int = 64  # slots staged per step of the blend
    # the slot budget P: with intersection_budget > 0 the stream has
    # max(intersection_budget, min_intersections) slots whatever the frame
    # (the JAX package's static budget, set by ops/budget.py:tuned_config)
    # and slots past it are dropped; with 0 the port sizes the stream per
    # frame (one host sync), where the JAX package would fix it at
    # max(intersection_multiple * N, min_intersections)
    intersection_multiple: int = 8
    min_intersections: int = 65536
    intersection_budget: int = 0
    # opacity-aware cutoff radius (pixel-exact, touches fewer tiles than the
    # classic 3-sigma rect; radii shrink for translucent splats)
    tight_radius: bool = True
    # blend input layout: "stream" = the kernels read each tile's run out of
    # the sorted slot stream; "dense" = a [T, K, 6 + C] block gathered per
    # tile (the JAX package's field of the same name)
    pallas_input: str = "stream"
    # the stream backward's rows: "auto" and "dense" = K2, rows at the stream
    # positions (the JAX package's [T, K, F] block and chunk gather give the
    # same per-splat sums); "compact" = K4, rows compacted by chunk with
    # their splat ids
    bwd_layout: str = "auto"
    # the backward's per-splat reduce (K3): "sorted_mxu" = each splat's rows
    # summed in the binning's fixed order (segment_reduce_perm), so steps
    # repeat bit for bit; "scatter" = atomic adds (segment_reduce), in an
    # order that changes from run to run; "auto" = REDUCE_BACKEND (the JAX
    # package's field, values and default)
    reduce_backend: str = "auto"
    # group renders: "auto" and "scan" = rasterize_scan_groups (each group
    # re-binned under group_config()); "dense" = rasterize_groups (one dense
    # union binning at the frame budgets, the blend and its replay batched
    # over the groups by the group entries of K5 and K6)
    group_render: str = "auto"
    # the budgets of one group's binning under "scan" (0: the frame's), set
    # by ops/budget.py:tuned_group_config
    group_intersection_budget: int = 0
    group_max_per_tile: int = 0
    # tile windows (stream layout): S > 0 lets a tile hold up to S *
    # max_per_tile slots, split into virtual tiles of at most max_per_tile
    # each and composed by _fold_windows. The blend's T < 1e-4 stop applies
    # to each window's own transmittance, so a later window may composite
    # past the point where the whole tile's blend stops: a windowed pixel
    # differs from the unwindowed one by at most the transmittance left
    # there, below T_EPS / (1 - alpha) of the slot that stopped it, times
    # the payload. Sized by ops/budget.py:tuned_config when the base config
    # sets it.
    tile_windows: int = 0
    # the virtual tiles past the band's real ones (0: the hard bound P //
    # max_per_tile, which never overflows)
    window_extra: int = 0
    # the slot budget of one rank's band under the sharded render
    # (parallel/render.py): each rank clips the gathered table to its own
    # tile rows and bins only those slots (0: each rank bins the whole
    # frame). Sized by ops/budget.py:tuned_config under a mesh.
    band_intersection_budget: int = 0

    def __post_init__(self):
        if self.chunk <= 0 or self.max_per_tile % self.chunk:
            raise ValueError("max_per_tile must be a multiple of chunk")
        for f in ("tile_windows", "window_extra", "band_intersection_budget"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be >= 0, got {getattr(self, f)}")
        if self.pallas_input not in LAYOUTS:
            raise ValueError(f"pallas_input must be one of {LAYOUTS}, got "
                             f"{self.pallas_input!r}")
        if self.bwd_layout not in BWD_LAYOUTS:
            raise ValueError(f"bwd_layout must be one of {BWD_LAYOUTS}, got "
                             f"{self.bwd_layout!r}")
        if self.group_render not in GROUP_RENDERS:
            raise ValueError(f"group_render must be one of {GROUP_RENDERS}, got "
                             f"{self.group_render!r}")
        if self.reduce_backend not in REDUCE_BACKENDS:
            raise ValueError(f"reduce_backend must be one of {REDUCE_BACKENDS}, got "
                             f"{self.reduce_backend!r}")

    def resolved_reduce_backend(self) -> str:
        """reduce_backend with "auto" read as REDUCE_BACKEND."""
        return REDUCE_BACKEND if self.reduce_backend == "auto" else self.reduce_backend

    def fixed_reduce_order(self) -> bool:
        """Whether K3 sums in the binning's fixed order ("sorted_mxu")."""
        return self.resolved_reduce_backend() == "sorted_mxu"

    def group_config(self) -> "RasterizeConfig":
        """The config one group's binning runs under (group_render "scan")."""
        upd = {}
        if self.group_intersection_budget:
            upd["intersection_budget"] = self.group_intersection_budget
        if self.group_max_per_tile:
            upd["max_per_tile"] = self.group_max_per_tile
        return dataclasses.replace(self, **upd) if upd else self

    def max_intersections(self, n: int) -> int:
        """The slot budget P of a scene of n splats (the JAX package's)."""
        if self.intersection_budget:
            return max(self.intersection_budget, self.min_intersections)
        return max(self.intersection_multiple * n, self.min_intersections)

    def fixed_budget(self, n: int) -> int:
        """The stream length bin_gaussians is given: P under a fixed budget,
        0 (sized per frame) without one."""
        return self.max_intersections(n) if self.intersection_budget else 0


@dataclasses.dataclass(frozen=True)
class SlotCounts:
    """One binning's slot stream, as the trainer's counters read it
    (Trainer.counters): its length P on the host, and as 0-d int32 device
    tensors the frame's rect slots (TileBins.total) and those lost to P and
    to max_per_tile. Its live slots are total - n_dropped - n_truncated."""

    padded: int
    total: torch.Tensor
    n_dropped: torch.Tensor
    n_truncated: torch.Tensor


def slot_counts(bins: TileBins) -> tuple[SlotCounts]:
    return (SlotCounts(bins.sorted_gauss.shape[0], bins.total, bins.n_dropped,
                       bins.n_truncated),)


@dataclasses.dataclass(frozen=True)
class RasterOut:
    image: torch.Tensor  # [H,W,C] composited payload (premultiplied + T*bg)
    alpha: torch.Tensor  # [H,W] 1 - final transmittance
    depth: torch.Tensor  # [H,W] premultiplied expected depth
    radii: torch.Tensor  # [N] int32, 0 => culled (visibility filter)
    n_dropped: torch.Tensor  # [] int32 slots lost to the fixed budget P
    n_truncated: torch.Tensor  # [] int32 slots lost to max_per_tile
    slots: tuple[SlotCounts, ...] = ()  # each binning's stream (each band's, group's)


def _grids(camera: Camera) -> tuple[int, int]:
    return (camera.width + TILE - 1) // TILE, (camera.height + TILE - 1) // TILE


@spanned(GEOMETRY)
def _project(camera: Camera, means3d, cov3d, opacities, config: RasterizeConfig,
             screen_tap=None) -> Projected:
    return project(means3d, cov3d, camera,
                   opacities=opacities if config.tight_radius else None,
                   screen_tap=screen_tap)


@dataclasses.dataclass(frozen=True)
class FrozenPlan:
    """One view's binning for frozen geometry (the JAX package's FrozenPlan).

    Past stage 0 only ins_feat trains, so a view's projected rects, depth
    ranks and sorted slot stream do not change from step to step: the plan
    keeps the stream's integer plumbing, and a step's whole binning (the
    expansion, the cull, the key sort, the tile ranges) becomes the one row
    gather by `g_sorted` that the blend makes anyway. Under reduce_backend
    "sorted_mxu" the plan also keeps the per-splat reduce's order
    (`slot_pos`, `splat_end`: the JAX package's ReducePlan), so the
    backward's reduce reads it and sorts nothing; under "scatter" it keeps
    none, as the JAX package's plan does.

    Exactness, when the plan lost no slot (n_dropped == n_truncated == 0):
    at the covariance it was built with, the step sees the same stream bit
    for bit; at a smaller covariance (the trainer's rescale factor < 1) the
    plan's pairs are a superset of a fresh binning's, and the extra ones
    stay below 1/255 where the opacity-aware radius binds, or composite a
    little more of the 3-sigma tail where that radius binds (the JAX
    package's bound: <= 0.02 of the image, <= 3% of pixels above 1e-5).
    Stream layout only; under tile windows the plan keeps the virtual
    tiles' maps as well. Fields may carry a leading view axis [V, ...]
    (`stack_plans`), from which `select` takes one view."""

    g_sorted: torch.Tensor  # [P] int32 splat per sorted slot
    tstart: torch.Tensor  # [T] int32 ([Tv] under tile windows)
    counts: torch.Tensor  # [T] int32
    total: torch.Tensor  # [] int32 (diagnostics, from the build)
    n_dropped: torch.Tensor
    n_truncated: torch.Tensor
    vt_real: torch.Tensor | None = None  # the windows' maps (TileBins), or None
    vt_first: torch.Tensor | None = None
    vt_n: torch.Tensor | None = None
    slot_pos: torch.Tensor | None = None  # the reduce's order (TileBins), or None
    splat_end: torch.Tensor | None = None

    def _tensors(self):
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def select(self, i) -> "FrozenPlan":
        """View i of stacked plans; i an int or a 1-element int64 tensor on
        the plans' device (a view index a captured step reads at replay)."""
        if isinstance(i, torch.Tensor):
            pick = lambda x: x.index_select(0, i)[0]  # noqa: E731
        else:
            pick = lambda x: x[i]  # noqa: E731
        return FrozenPlan(**{k: pick(x) for k, x in self._tensors()})

    def nbytes(self) -> int:
        return sum(x.nbytes for _, x in self._tensors())


def stack_plans(plans: list[FrozenPlan], n: int) -> FrozenPlan:
    """Per-view plans stacked along a leading view axis; streams of unequal
    length (sized per frame) are padded with slots of id n, past every
    tile (and slot_pos with 0, past every splat's range), and windowed plans
    of unequal virtual-tile counts with dead windows (count 0, start at the
    padded stream's end)."""
    P = max(p.g_sorted.shape[0] for p in plans)

    def stack(name: str, value: int | None = None):
        xs = [getattr(p, name) for p in plans]
        if xs[0] is None:
            return None
        L = max(x.shape[0] for x in xs) if xs[0].dim() else 0
        if value is not None:
            xs = [torch.nn.functional.pad(x, (0, L - x.shape[0]), value=value) for x in xs]
        return torch.stack(xs)

    last = plans[0].vt_first.shape[0] - 1 if plans[0].vt_first is not None else 0
    return FrozenPlan(g_sorted=stack("g_sorted", n), tstart=stack("tstart", P),
                      counts=stack("counts", 0), total=stack("total"),
                      n_dropped=stack("n_dropped"), n_truncated=stack("n_truncated"),
                      vt_real=stack("vt_real", last), vt_first=stack("vt_first"),
                      vt_n=stack("vt_n"), slot_pos=stack("slot_pos", 0),
                      splat_end=stack("splat_end"))


@torch.no_grad()
def build_frozen_plan(camera: Camera, means3d, cov3d, opacities,
                      config: RasterizeConfig) -> FrozenPlan:
    """A view's FrozenPlan: the binning of this camera, geometry and config
    (at rescale factor 1, the superset the rescaled steps ride), with the
    reduce's order under reduce_backend "sorted_mxu"."""
    if config.pallas_input != "stream":
        raise ValueError("frozen plans need pallas_input='stream'")
    camera = camera.to(means3d.device)
    _, bins, _ = _prepare(camera, means3d, cov3d, opacities, config,
                          reduce_order=config.fixed_reduce_order())
    return FrozenPlan(g_sorted=bins.sorted_gauss, tstart=bins.tile_start,
                      counts=bins.counts, total=bins.total, n_dropped=bins.n_dropped,
                      n_truncated=bins.n_truncated, vt_real=bins.vt_real,
                      vt_first=bins.vt_first, vt_n=bins.vt_n, slot_pos=bins.slot_pos,
                      splat_end=bins.splat_end)


def reduce_order_wanted(config: RasterizeConfig) -> bool:
    """Whether a binning under config returns the reduce's order: under
    "sorted_mxu", where autograd records (a backward may follow)."""
    return config.fixed_reduce_order() and torch.is_grad_enabled()


def _prepare(camera: Camera, means3d, cov3d, opacities, config: RasterizeConfig,
             screen_tap=None, proj: Projected | None = None,
             rank: torch.Tensor | None = None, frozen: FrozenPlan | None = None,
             tile_lo: int = 0, tile_hi: int | None = None,
             reduce_order: bool | None = None) -> tuple[Projected, TileBins, tuple[int, int]]:
    """Project (unless proj is given) and bin, or take the bins of a
    FrozenPlan. tile_lo / tile_hi: the band of tiles to bin (all by
    default); the stream layout bins with config.tile_windows. reduce_order:
    whether the bins carry the reduce's order (default
    `reduce_order_wanted`)."""
    grid_x, grid_y = _grids(camera)
    if proj is None:
        proj = _project(camera, means3d, cov3d, opacities, config, screen_tap)
    stream = config.pallas_input == "stream"
    if frozen is not None and not stream:
        raise ValueError("frozen plans apply to pallas_input='stream' only")
    with span(BIN):
        if frozen is not None:
            bins = TileBins(counts=frozen.counts, tile_start=frozen.tstart,
                            sorted_gauss=frozen.g_sorted, total=frozen.total,
                            n_dropped=frozen.n_dropped, n_truncated=frozen.n_truncated,
                            deepest=frozen.counts.max(), vt_real=frozen.vt_real,
                            vt_first=frozen.vt_first, vt_n=frozen.vt_n,
                            slot_pos=frozen.slot_pos, splat_end=frozen.splat_end)
        else:
            bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile,
                                 dense=not stream, rank=rank,
                                 max_intersections=config.fixed_budget(means3d.shape[0]),
                                 tile_lo=tile_lo, tile_hi=tile_hi,
                                 window_depth=config.tile_windows if stream else 0,
                                 window_extra=config.window_extra,
                                 reduce_order=(reduce_order_wanted(config)
                                               if reduce_order is None else reduce_order))
    return proj, bins, (grid_x, grid_y)


@torch.no_grad()
def deepest_tile(camera: Camera, means3d, cov3d, opacities,
                 config: RasterizeConfig) -> int:
    """Slots in this frame's deepest tile, before the max_per_tile cap."""
    config = dataclasses.replace(config, pallas_input="stream")  # no [T, K] matrix
    _, bins, _ = _prepare(camera.to(means3d.device), means3d, cov3d, opacities, config)
    return int(bins.deepest)


def gather_rows(mean2d, conic, opac, payload, idx) -> torch.Tensor:
    """The blend's input rows: for each slot of idx (any shape), its splat's
    mean2d (2), conic (3), opacity (1) and payload (C). -> [*idx.shape, 6 + C].
    With the stream's sorted_gauss [P] these are the sorted slot rows; with
    the dense gauss_idx [T, K] the block `gdata` (the JAX package's
    rasterize_pallas.py:_make_gdata). A slot of id n (past the last tile of
    a fixed-budget stream) takes splat n - 1's row, which no kernel reads."""
    table = torch.cat([mean2d, conic, opac[:, None], payload], dim=-1)
    return table[torch.clamp(idx.to(torch.int64), max=table.shape[0] - 1)]


def _order(bins: TileBins, config: RasterizeConfig):
    """The reduce's order the backward takes: (slot_pos, splat_end) under
    "sorted_mxu" where autograd records, else None (K3's atomic entry, or
    no backward)."""
    if not reduce_order_wanted(config):
        return None
    if bins.slot_pos is None:
        raise ValueError("reduce_backend 'sorted_mxu' needs bins with the reduce's order "
                         "(bin_gaussians(reduce_order=True), or a FrozenPlan built "
                         "under it)")
    return bins.slot_pos, bins.splat_end


@spanned(REDUCE)
def _per_splat(d_rows, ids, n: int, order, groups: int = 1):
    """K3: d_rows [G R, F] -> [G n, F], in the order (slot_pos, splat_end)
    by `segment_reduce_perm`, or, with order None, by ids [G R] in atomic
    order."""
    if order is None:
        return segment_reduce(d_rows, ids, groups * n)
    return segment_reduce_perm(d_rows, order[0], order[1], n, groups)


class StreamBlend(torch.autograd.Function):
    """Blend of the sorted slot stream with a per-splat backward.

    forward(mean2d [N,2], conic [N,3], opac [N], payload [N,C], sorted_gauss,
    tile_start, counts, toff, grid_x, chunk, bwd_layout, order) -> (accum
    [T, C, 256], t_final [T, 256]). The rows are gathered inside the
    forward, where autograd records nothing (the JAX package's stop_gradient
    on the carry): the backward reduces the per-slot rows to per-splat
    gradients itself, so autograd must not differentiate the gather as well.
    The backward takes the rows from K2 (at the stream positions, ids from
    sorted_gauss) or, for bwd_layout "compact", from K4 (compacted, with
    their ids), and sums them per splat with K3: in the order (slot_pos,
    splat_end) of `order` (the compact rows' positions through
    `compact_positions`), or, with order None, in atomic order by the ids."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, sorted_gauss, tile_start,
                counts, toff, grid_x: int, chunk: int, bwd_layout: str = "auto",
                order=None):
        rows = gather_rows(mean2d, conic, opac, payload, sorted_gauss)
        accum, t_final = blend_stream_fwd(rows, counts, tile_start, toff, grid_x,
                                          chunk)
        ctx.save_for_backward(rows, sorted_gauss, tile_start, counts, toff,
                              accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        ctx.compact = bwd_layout == "compact"
        ctx.order = order
        return accum, t_final

    @staticmethod
    @spanned(BLEND_BWD)
    def backward(ctx, g_accum, g_t):
        rows, sorted_gauss, tile_start, counts, toff, accum, t_final = ctx.saved_tensors
        cot = (accum, t_final, g_accum.contiguous(), g_t.contiguous(), ctx.grid_x,
               ctx.chunk)
        order = ctx.order
        if ctx.compact:
            d_rows, ids = blend_stream_bwd_compact(rows, counts, tile_start, toff,
                                                   sorted_gauss, *cot, ctx.n)
            if order is not None:  # the compact row of each expanded slot
                rows_at = compact_positions(tile_start, counts, ctx.chunk, rows.shape[0])
                order = (rows_at[order[0].to(torch.int64)], order[1])
        else:
            d_rows = blend_stream_bwd(rows, counts, tile_start, toff, *cot)
            ids = sorted_gauss
        per = _per_splat(d_rows, ids, ctx.n, order)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None, None, None, None, None)


class DenseBlend(torch.autograd.Function):
    """Blend of a dense [T, K] layout with a per-splat backward (the JAX
    package's custom VJP rasterize_pallas.py:blend_tiles_pallas).

    forward(mean2d [N,2], conic [N,3], opac [N], payload [N,C], gauss_idx
    [T,K], sorted_gauss [P], tile_start [T], counts [T], grid_x, chunk,
    tile_offset, order) -> (accum [T, C, 256], t_final [T, 256]); tile t
    shades image tile t + tile_offset (a band's first tile). The block gdata
    [T, K, 6+C] is gathered inside the forward, where autograd records
    nothing, as in StreamBlend. The backward takes the live rows from the K6
    replay, at the stream positions tile_start[t] + k the block was gathered
    from, and sums them per splat with K3 (P rows, not T x K) as StreamBlend
    does: in `order`, or by sorted_gauss in atomic order."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac, payload, gauss_idx, sorted_gauss, tile_start,
                counts, grid_x: int, chunk: int, tile_offset: int = 0, order=None):
        gdata = gather_rows(mean2d, conic, opac, payload, gauss_idx)
        accum, t_final = blend_tiles_fwd(gdata, counts, grid_x, chunk, tile_offset)
        ctx.save_for_backward(gdata, sorted_gauss, tile_start, counts, accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.n = grid_x, chunk, mean2d.shape[0]
        ctx.tile_offset, ctx.order = tile_offset, order
        return accum, t_final

    @staticmethod
    @spanned(BLEND_BWD)
    def backward(ctx, g_accum, g_t):
        gdata, sorted_gauss, tile_start, counts, accum, t_final = ctx.saved_tensors
        d_rows = blend_tiles_bwd(gdata, counts, tile_start, sorted_gauss.shape[0], accum,
                                 t_final, g_accum.contiguous(), g_t.contiguous(),
                                 ctx.grid_x, ctx.chunk, ctx.tile_offset)
        per = _per_splat(d_rows, sorted_gauss, ctx.n, ctx.order)
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, N_GEOM:],
                None, None, None, None, None, None, None, None)


class GroupDenseBlend(torch.autograd.Function):
    """The dense blend once per group of opacities, with a per-splat backward
    (the JAX package's vmap of its dense blend over the groups, in
    rasterize_groups).

    forward(mean2d [N,2], conic [N,3], opac_g [G,N], payload [N,C],
    gauss_idx [T,K], sorted_gauss [P], tile_start [T], counts [T], grid_x,
    chunk, order) -> (accum [G, T, C, 256], t_final [G, T, 256]). One block
    [T, K, 6+C] is gathered for all groups (its opacity column is unused),
    and the group entry of K5 blends it with each group's opacity by splat
    id. The backward's group entry of K6 gives each group's live rows at
    their stream positions, [G, P, 6+C]; K3 sums them into [G, n, 6+C],
    each group in `order`, or by g n + sorted_gauss in atomic order: the
    opacity gradient stays per group, the others are summed over the
    groups."""

    @staticmethod
    def forward(ctx, mean2d, conic, opac_g, payload, gauss_idx, sorted_gauss,
                tile_start, counts, grid_x: int, chunk: int, order=None):
        n = mean2d.shape[0]
        opac_g = opac_g.contiguous()
        gdata = gather_rows(mean2d, conic, mean2d.new_zeros(n), payload, gauss_idx)
        accum, t_final = blend_tiles_fwd_groups(gdata, gauss_idx, opac_g, counts,
                                                grid_x, chunk)
        ctx.save_for_backward(gdata, gauss_idx, opac_g, sorted_gauss, tile_start,
                              counts, accum, t_final)
        ctx.grid_x, ctx.chunk, ctx.order = grid_x, chunk, order
        return accum, t_final

    @staticmethod
    @spanned(BLEND_BWD)
    def backward(ctx, g_accum, g_t):
        gdata, gauss_idx, opac_g, sorted_gauss, tile_start, counts, accum, t_final = (
            ctx.saved_tensors)
        G, n = opac_g.shape
        P = sorted_gauss.shape[0]
        d_rows = blend_tiles_bwd_groups(gdata, gauss_idx, opac_g, counts, tile_start, P,
                                        accum, t_final, g_accum.contiguous(),
                                        g_t.contiguous(), ctx.grid_x, ctx.chunk)
        ids = None
        if ctx.order is None:
            sg = sorted_gauss.to(torch.int64)
            base = torch.arange(G, device=sg.device)[:, None] * n
            ids = torch.where((sg >= 0) & (sg < n), base + sg, G * n).to(torch.int32)
            ids = ids.reshape(-1)
        per = _per_splat(d_rows.reshape(G * P, -1), ids, n, ctx.order, G).reshape(G, n, -1)
        rest = per.sum(dim=0)
        return (rest[:, 0:2], rest[:, 2:5], per[:, :, 5], rest[:, N_GEOM:],
                None, None, None, None, None, None, None)


def _untile(x: torch.Tensor, grid_x: int, grid_y: int, H: int, W: int) -> torch.Tensor:
    """[G * T, 256, ch] tiles -> [G, H, W, ch] (G = 1 for [T, ...]); crops the
    ragged last tile row and column."""
    ch = x.shape[-1]
    x = x.reshape(-1, grid_y, grid_x, TILE, TILE, ch)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, grid_y * TILE, grid_x * TILE, ch)
    return x[:, :H, :W]


def _images(camera: Camera, grids, accum, t_final, bg, row_lo: int = 0,
            rows: int | None = None):
    """accum [G * T, C+1, 256] (payload + depth), t_final [G * T, 256] ->
    image [G, H, W, C] over bg, alpha [G, H, W], depth [G, H, W]. A band of
    `rows` tile rows from grid row row_lo gives that band's image rows
    only."""
    grid_x, grid_y = grids
    rows = grid_y if rows is None else rows
    acc = accum.transpose(1, 2)  # [G * T, 256, C+1]
    C = acc.shape[-1] - 1
    img_tiles = acc[:, :, :C] + t_final[..., None] * bg[None, None, :]
    H, W = min(rows * TILE, camera.height - row_lo * TILE), camera.width
    image = _untile(img_tiles, grid_x, rows, H, W)
    alpha = _untile((1.0 - t_final)[..., None], grid_x, rows, H, W)[..., 0]
    depth = _untile(acc[:, :, C:], grid_x, rows, H, W)[..., 0]
    return image, alpha, depth


def _fold_windows(accum, t_final, vt_first, vt_n, S: int):
    """Composite each real tile's windows front to back, (a, T) o (a', T')
    = (a + T a', T T') (the JAX package's _fold_windows). accum [Tv, C, 256]
    and t_final [Tv, 256], each window blended from a transmittance of 1 ->
    ([band, C, 256], [band, 256]). Plain differentiable gathers: autograd
    hands the blend per-window cotangents."""
    Tv = accum.shape[0]
    first = torch.clamp(vt_first.to(torch.int64), max=Tv - 1)
    acc = accum[first]
    t = t_final[first]
    for s in range(1, S):
        idx = torch.clamp(first + s, max=Tv - 1)
        live = (s < vt_n)[:, None]
        acc = acc + torch.where(live[..., None], t[:, None, :] * accum[idx], 0.0)
        t = torch.where(live, t * t_final[idx], t)
    return acc, t


def _blend_inputs(proj: Projected, opacities, payload):
    """The blend's per-splat columns: opacity 0 where the projection culled,
    and depth appended to the payload."""
    opac = torch.where(proj.valid, opacities, 0.0)
    return opac, torch.cat([payload, proj.depth[:, None]], dim=-1)


def _blend(proj: Projected, bins: TileBins, opac, full_payload, grid_x: int,
           config: RasterizeConfig, tile_lo: int = 0, toff=None):
    """Blend the binned band of tiles from tile_lo (virtual tiles folded) ->
    (accum [band, C+1, 256], t_final [band, 256]). toff: the image tile of
    each (virtual) tile, when it is not tile_lo + its place in the band."""
    if config.pallas_input == "dense":
        return DenseBlend.apply(
            proj.mean2d, proj.conic, opac, full_payload, bins.gauss_idx,
            bins.sorted_gauss, bins.tile_start, bins.counts, grid_x, config.chunk,
            tile_lo, _order(bins, config))
    if toff is None:
        vt = (bins.vt_real if bins.vt_real is not None else
              torch.arange(bins.counts.shape[0], device=bins.counts.device))
        toff = (tile_lo + vt).to(torch.int32)
    accum, t_final = StreamBlend.apply(
        proj.mean2d, proj.conic, opac, full_payload, bins.sorted_gauss,
        bins.tile_start, bins.counts, toff, grid_x, config.chunk, config.bwd_layout,
        _order(bins, config))
    if bins.vt_real is not None:
        accum, t_final = _fold_windows(accum, t_final, bins.vt_first, bins.vt_n,
                                       config.tile_windows)
    return accum, t_final


@spanned(BLEND)
def _composite(camera: Camera, proj: Projected, bins: TileBins, grids,
               opacities, payload, bg, config: RasterizeConfig, tile_lo: int = 0):
    grid_x = grids[0]
    opac, full_payload = _blend_inputs(proj, opacities, payload)
    accum, t_final = _blend(proj, bins, opac, full_payload, grid_x, config, tile_lo)
    image, alpha, depth = _images(camera, grids, accum, t_final, bg, tile_lo // grid_x,
                                  accum.shape[0] // grid_x)
    return image[0], alpha[0], depth[0]


def rasterize(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    screen_tap: torch.Tensor | None = None,
    proj: Projected | None = None,
    rank: torch.Tensor | None = None,
    frozen: FrozenPlan | None = None,
) -> RasterOut:
    """Render a per-splat payload [N, C] to an [H, W, C] image, plus alpha,
    premultiplied depth and per-splat radii. screen_tap [N, 2]: zeros added
    to the NDC position, whose gradient is the densification signal.
    proj / rank: a projection and depth rank computed once outside, which
    group renders share across their groups. frozen: this view's
    FrozenPlan, built under the same camera, geometry and config, in place
    of the binning (stream layout)."""
    camera = camera.to(means3d.device)
    proj, bins, grids = _prepare(camera, means3d, cov3d, opacities, config,
                                 screen_tap, proj, rank, frozen)
    image, alpha, depth = _composite(camera, proj, bins, grids, opacities,
                                     payload, bg, config)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated,
                     slots=slot_counts(bins))


def rasterize_banded(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    bands: int = 4,
    screen_tap: torch.Tensor | None = None,
) -> RasterOut:
    """Render in `bands` horizontal bands of tile rows (the JAX package's
    rasterize_banded, rasterize.py:612): each band bins the frame's slots
    again but keeps only its own tiles' runs, and blends them (K1, or K5
    with the band's tile offset), which bounds the per-tile buffers (the
    dense block, [band, K, 6 + C]) by the band. One projection and depth
    rank serve every band. Pixel-exact: the bands' images, stacked, are the
    single pass's. n_dropped counts the frame's dropped slots once (every
    band sees the whole stream); n_truncated sums over the bands."""
    camera = camera.to(means3d.device)
    grid_x, grid_y = _grids(camera)
    rows_per = -(-grid_y // bands)
    proj = _project(camera, means3d, cov3d, opacities, config, screen_tap)
    with span(BIN):
        rank = depth_rank(proj.depth.detach())
    outs, n_dropped, n_truncated, slots = [], 0, 0, ()
    for r0 in range(0, grid_y, rows_per):
        lo, hi = r0 * grid_x, min(grid_y, r0 + rows_per) * grid_x
        _, bins, grids = _prepare(camera, means3d, cov3d, opacities, config, proj=proj,
                                  rank=rank, tile_lo=lo, tile_hi=hi)
        outs.append(_composite(camera, proj, bins, grids, opacities, payload, bg, config,
                               lo))
        n_dropped = n_dropped + bins.n_dropped
        n_truncated = n_truncated + bins.n_truncated
        slots += slot_counts(bins)
    image, alpha, depth = (torch.cat(x, dim=0) for x in zip(*outs))
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=n_dropped // len(outs), n_truncated=n_truncated, slots=slots)


def cull_outside(proj: Projected, keep: torch.Tensor) -> Projected:
    """proj with the splats outside `keep` culled: radius, cull radius,
    tiles and validity zeroed. Kept splats keep every field, and their
    autograd path, as they were."""
    return dataclasses.replace(
        proj, radius=torch.where(keep, proj.radius, 0),
        cull_radius=torch.where(keep, proj.cull_radius, 0.0),
        num_tiles=torch.where(keep, proj.num_tiles, 0), valid=proj.valid & keep)


def rasterize_scan_groups(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,  # [G, N] per-group masked opacities
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
) -> RasterOut:
    """Render G subsets of one scene, one group after the other (the JAX
    package's lax.scan of single-group rasterizes, rasterize.py:666).

    One projection, at the union of the groups' opacities, and one depth
    rank serve every group: a member's masked opacity is its real opacity,
    so its projected fields are what a per-group projection would give, and
    a non-member is culled (`cull_outside`). Each group then bins only its own
    splats, under the group budgets (`config.group_config()`), and blends them
    in any layout; gradients flow as through `rasterize`. -> RasterOut with
    image [G, H, W, C], alpha and depth [G, H, W]; radii the maximum over
    groups, n_dropped / n_truncated the sums."""
    camera = camera.to(means3d.device)
    gcfg = config.group_config()
    union = opacities.max(dim=0).values
    proj_u = _project(camera, means3d, cov3d, union, config)
    with span(BIN):
        rank = depth_rank(proj_u.depth.detach())
    outs = [rasterize(camera, means3d, cov3d, opac_g, payload, bg, gcfg,
                      proj=cull_outside(proj_u, opac_g > 0.0), rank=rank)
            for opac_g in opacities]
    return RasterOut(
        image=torch.stack([r.image for r in outs]),
        alpha=torch.stack([r.alpha for r in outs]),
        depth=torch.stack([r.depth for r in outs]),
        radii=torch.stack([r.radii for r in outs]).max(dim=0).values,
        n_dropped=sum(r.n_dropped for r in outs),
        n_truncated=sum(r.n_truncated for r in outs),
        slots=sum((r.slots for r in outs), ()))


def rasterize_groups(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,  # [G, N] per-group masked opacities
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
) -> RasterOut:
    """Render G subsets of one scene over one shared binning
    (group_render="dense"; the JAX package's rasterize_groups,
    rasterize.py:842).

    The union of the groups (the maximum opacity over them) is projected
    and binned once, in the dense layout, at the frame budgets; the group
    entries of K5 and K6 then blend that one block once per group, each
    group at its own opacities (`GroupDenseBlend`). A splat of opacity 0
    composites nothing, so each group's image is that of its subset. Every
    group walks the whole union: this pays where the groups overlap and G is
    small. -> RasterOut with image [G, H, W, C], alpha and depth [G, H, W];
    the union's radii, n_dropped and n_truncated."""
    camera = camera.to(means3d.device)
    dense = dataclasses.replace(config, pallas_input="dense")
    proj, bins, grids = _prepare(camera, means3d, cov3d, opacities.max(dim=0).values,
                                 dense)
    with span(BLEND):
        opac_g = torch.where(proj.valid[None, :], opacities, 0.0)
        full_payload = torch.cat([payload, proj.depth[:, None]], dim=-1)
        accum, t_final = GroupDenseBlend.apply(
            proj.mean2d, proj.conic, opac_g, full_payload, bins.gauss_idx,
            bins.sorted_gauss, bins.tile_start, bins.counts, grids[0], config.chunk,
            _order(bins, dense))
        image, alpha, depth = _images(camera, grids, accum.flatten(0, 1),
                                      t_final.flatten(0, 1), bg)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated,
                     slots=slot_counts(bins))


def rasterize_partition(
    camera: Camera,
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacities: torch.Tensor,  # [N] union-masked (0 for splats in no group)
    group_of: torch.Tensor,  # [N] int group of each splat, 0..G-1
    num_groups: int,
    payload: torch.Tensor,
    bg: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
    proj: Projected | None = None,
    rank: torch.Tensor | None = None,
) -> RasterOut:
    """Render G disjoint groups (a cluster partition) in one pass (the JAX
    package's rasterize.py:747).

    Partition binning (`bin_gaussians(group_of=...)`) puts each slot in the
    virtual tile group_of * T + tile, so one expansion, one sort and one K1
    launch over G * T virtual tiles (pixels of tile vt % T) cover every
    group; each virtual tile's run holds exactly the slots a single-group
    binning gives. Splats outside every group must be culled in proj (zero
    opacity, or proj masked by the caller). Stream layout only; under tile
    windows each (group, tile)'s windows are folded as in `rasterize`.
    -> RasterOut with image [G, H, W, C], alpha and depth [G, H, W], the
    union's radii."""
    if config.pallas_input != "stream":
        raise ValueError("rasterize_partition needs pallas_input='stream'")
    camera = camera.to(means3d.device)
    grid_x, grid_y = _grids(camera)
    T = grid_x * grid_y
    if proj is None:
        proj = _project(camera, means3d, cov3d, opacities, config)
    with span(BIN):
        bins = bin_gaussians(proj, grid_x, grid_y, config.max_per_tile, rank=rank,
                             group_of=group_of, num_groups=num_groups,
                             max_intersections=config.fixed_budget(means3d.shape[0]),
                             window_depth=config.tile_windows,
                             window_extra=config.window_extra,
                             reduce_order=reduce_order_wanted(config))
    with span(BLEND):
        opac, full_payload = _blend_inputs(proj, opacities, payload)
        vt = (bins.vt_real if bins.vt_real is not None
              else torch.arange(num_groups * T, device=bins.counts.device))
        accum, t_final = _blend(proj, bins, opac, full_payload, grid_x, config,
                                toff=(vt % T).to(torch.int32))
        image, alpha, depth = _images(camera, (grid_x, grid_y), accum, t_final, bg)
    return RasterOut(image=image, alpha=alpha, depth=depth, radii=proj.radius,
                     n_dropped=bins.n_dropped, n_truncated=bins.n_truncated,
                     slots=slot_counts(bins))
