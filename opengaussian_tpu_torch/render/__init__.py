"""Render orchestration: GaussianState -> RGB, depth, instance features and
per-cluster renders.

Port of opengaussian_tpu/render/__init__.py (reference
gaussian_renderer/__init__.py:22-373): `render` makes at most two rasterizer
calls per view, one for SH color at true scale and one 6-channel
instance-feature pass at the (optionally) rescaled scale. `render_clusters`
renders each of G clusters alone (stage 2.2 and the pseudo-label sweeps)
through `rasterize_scan_groups`, and `render_clusters_partition` renders G
disjoint clusters in one pass (stage 3) through `rasterize_partition`, and
`render_selection` renders one chosen subset of splats (the text and click
queries) through `rasterize_scan_groups` with one group. With
group_render="dense" the group renders go through `rasterize_groups` (one
union binning, the group entries of K5 and K6); with a view's FrozenPlan
(`frozen=`) `render` and `render_clusters` skip the binning. The
reference's data-dependent `continue` filters (a cluster with too few
splats, a silhouette below 0.8) become the `cluster_valid` and
`cluster_occur` flags.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import GaussianState
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import (
    FrozenPlan,
    RasterizeConfig,
    RasterOut,
    cull_outside,
    rasterize,
    rasterize_groups,
    rasterize_partition,
    rasterize_scan_groups,
)
from opengaussian_tpu_torch.ops.sh import sh_to_rgb

# cluster-render gates (reference gaussian_renderer/__init__.py:184, :248 and
# train.py's occur checks)
COARSE_SCALE_LIMIT = 0.5  # better_vis coarse cluster scale cull
LEAF_SCALE_LIMIT = 0.1  # leaf-level scale cull
MIN_CLUSTER_POINTS = 100  # coarse cluster validity
OCCUR_SIL_THRESHOLD = 0.8  # silhouette peak for cluster_occur
SELECTION_MIN_POINTS = 10  # render_selection validity


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    """The render modes of the JAX package's RenderOutputs that this path
    produces. None where a mode is off."""

    render: torch.Tensor | None = None  # [H,W,3]
    alpha: torch.Tensor | None = None  # [H,W]
    depth: torch.Tensor | None = None  # [H,W]
    silhouette: torch.Tensor | None = None  # [H,W] alpha of the feature pass
    ins_feat: torch.Tensor | None = None  # [H,W,6]
    cluster_imgs: torch.Tensor | None = None  # [G,H,W,6]
    cluster_silhouettes: torch.Tensor | None = None  # [G,H,W]
    cluster_occur: torch.Tensor | None = None  # [G] bool (max silhouette > 0.8)
    cluster_valid: torch.Tensor | None = None  # [G] bool (enough splats)
    screen_grad_tap: torch.Tensor | None = None  # the [N,2] tap whose grad
    # is the densification signal
    visibility_filter: torch.Tensor | None = None  # [N] bool
    radii: torch.Tensor | None = None  # [N] int32
    n_lost: torch.Tensor | None = None  # [] int32 dropped+truncated slots


def encoded_ins_feat(gs: GaussianState, quantized=None, origin_feat: bool = False):
    """(normalized feat + 1)/2, the color-slot encoding the reference uses
    (gaussian_renderer/__init__.py:129)."""
    q = None if origin_feat else quantized
    return (gs.normalized_ins_feat(q) + 1.0) / 2.0


def render(
    camera: Camera,
    gs: GaussianState,
    bg: torch.Tensor,  # [3]
    active_sh_degree: int,
    config: RasterizeConfig = RasterizeConfig(),
    *,
    render_color: bool = True,
    render_feat_map: bool = False,
    origin_feat: bool = False,
    quantized_feat: torch.Tensor | None = None,
    rescale_factor: torch.Tensor | float = 1.0,
    scale_modifier: float = 1.0,
    screen_tap: torch.Tensor | None = None,
    frozen: FrozenPlan | None = None,
) -> RenderOutputs:
    """Render one view: the color pass and/or the instance-feature pass.
    screen_tap [N,2] (zeros) joins the color pass's NDC positions and comes
    back as `screen_grad_tap`. frozen: the view's FrozenPlan, built at
    scale_modifier and rescale_factor 1 under this camera and geometry; it
    serves both passes (a rescaled feature pass rides the superset plan)."""
    camera = camera.to(gs.device)
    scales = gs.scales * scale_modifier
    opac = gs.opacity
    out = RenderOutputs()

    if render_color:
        cov3d = build_cov3d(scales, gs.quats)
        rgb = sh_to_rgb(active_sh_degree, gs.sh, gs.means, camera.cam_center)
        r = rasterize(camera, gs.means, cov3d, opac, rgb, bg, config, screen_tap,
                      frozen=frozen)
        out = dataclasses.replace(
            out, render=r.image, alpha=r.alpha, depth=r.depth, radii=r.radii,
            visibility_filter=r.radii > 0, n_lost=r.n_dropped + r.n_truncated,
            screen_grad_tap=screen_tap,
        )

    if render_feat_map:
        feat = encoded_ins_feat(gs, quantized_feat, origin_feat)
        cov3d_f = build_cov3d(scales * rescale_factor, gs.quats)
        fbg = torch.cat([bg, bg])  # the reference applies the same 3-ch bg
        rf = rasterize(camera, gs.means, cov3d_f, opac, feat, fbg, config, frozen=frozen)
        lost = rf.n_dropped + rf.n_truncated
        out = dataclasses.replace(
            out, ins_feat=rf.image, silhouette=rf.alpha,
            n_lost=lost if out.n_lost is None else torch.maximum(out.n_lost, lost),
        )
        if out.radii is None:
            out = dataclasses.replace(out, radii=rf.radii,
                                      visibility_filter=rf.radii > 0)
    return out


def _cluster_keep(gs: GaussianState, cluster_ids, group_ids, better_vis: bool,
                  scale_limit: float) -> torch.Tensor:
    """[G, N] bool: the alive splats of each group's cluster (with the
    better_vis scale cull)."""
    if not isinstance(group_ids, torch.Tensor):  # a host list: copied, no sync
        group_ids = torch.as_tensor(group_ids, dtype=torch.int64).to(gs.device,
                                                                     non_blocking=True)
    group_ids = group_ids.reshape(-1)
    keep = (cluster_ids[None, :] == group_ids[:, None]) & gs.alive[None, :]
    if better_vis:
        keep = keep & torch.all(gs.scales < scale_limit, dim=-1)[None, :]
    return keep


def _cluster_outputs(r, counts, min_points: int) -> RenderOutputs:
    valid = counts >= min_points
    occur = r.alpha.flatten(1).max(dim=1).values > OCCUR_SIL_THRESHOLD
    return RenderOutputs(cluster_imgs=r.image, cluster_silhouettes=r.alpha,
                         cluster_occur=occur & valid, cluster_valid=valid,
                         radii=r.radii, visibility_filter=r.radii > 0,
                         n_lost=r.n_dropped + r.n_truncated)


def render_clusters(
    camera: Camera,
    gs: GaussianState,
    bg: torch.Tensor,
    cluster_ids: torch.Tensor,  # [N] int cluster of each splat
    group_ids,  # [G] int: the cluster each group renders
    config: RasterizeConfig = RasterizeConfig(),
    *,
    quantized_feat: torch.Tensor | None = None,
    origin_feat: bool = False,
    rescale_factor: torch.Tensor | float = 1.0,
    better_vis: bool = False,
    scale_limit: float = COARSE_SCALE_LIMIT,  # 0.5 coarse / 0.1 leaf
    min_points: int = MIN_CLUSTER_POINTS,
    frozen: FrozenPlan | None = None,
) -> RenderOutputs:
    """Per-cluster feature and silhouette renders (reference
    gaussian_renderer/__init__.py:174-356): group g renders the alive
    splats with cluster_ids == group_ids[g] (with better_vis, only those
    smaller than scale_limit on every axis). A group is valid when it kept
    at least min_points splats, occurs when its silhouette peaks above 0.8.
    group_ids: a sequence of ints, or an int64 tensor on the device (a
    captured step's root id). frozen: the view's full-frame FrozenPlan; each
    group is then a masked-opacity blend over its stream, at the frame
    budgets. -> RenderOutputs with the cluster_* fields, radii and n_lost."""
    camera = camera.to(gs.device)
    cov3d = build_cov3d(gs.scales * rescale_factor, gs.quats)
    payload = encoded_ins_feat(gs, quantized_feat, origin_feat)
    keep = _cluster_keep(gs, cluster_ids, group_ids, better_vis, scale_limit)
    return _render_groups(camera, gs, keep, payload, torch.cat([bg, bg]), cov3d, config,
                          min_points, frozen)


def render_clusters_partition(
    camera: Camera,
    gs: GaussianState,
    bg: torch.Tensor,
    cluster_ids: torch.Tensor,  # [N] int cluster of each splat
    group_ids,  # [G] int: disjoint clusters, one per group
    config: RasterizeConfig = RasterizeConfig(),
    *,
    quantized_feat: torch.Tensor | None = None,
    origin_feat: bool = False,
    rescale_factor: torch.Tensor | float = 1.0,
    better_vis: bool = False,
    scale_limit: float = COARSE_SCALE_LIMIT,
    min_points: int = MIN_CLUSTER_POINTS,
    proj=None,
    rank: torch.Tensor | None = None,
) -> RenderOutputs:
    """render_clusters for disjoint clusters, all G in one partition
    rasterize (one binning, one K1 launch; stream layout only). proj / rank:
    a projection of every alive splat and its depth rank, computed once and
    shared, e.g. across the roots of one view; the splats outside the
    groups are culled from it here."""
    camera = camera.to(gs.device)
    cov3d = build_cov3d(gs.scales * rescale_factor, gs.quats)
    payload = encoded_ins_feat(gs, quantized_feat, origin_feat)
    keep = _cluster_keep(gs, cluster_ids, group_ids, better_vis, scale_limit)
    union = keep.any(dim=0)
    group_of = torch.argmax(keep.to(torch.int32), dim=0)  # disjoint: at most one hit
    opac = torch.where(union, gs.opacity, 0.0)
    if proj is not None:
        proj = cull_outside(proj, union)
    r = rasterize_partition(camera, gs.means, cov3d, opac, group_of, keep.shape[0],
                            payload, torch.cat([bg, bg]), config.group_config(), proj=proj,
                            rank=rank)
    return _cluster_outputs(r, keep.sum(dim=-1), min_points)


def render_selection(
    camera: Camera,
    gs: GaussianState,
    bg: torch.Tensor,
    select_mask: torch.Tensor,  # [N] bool, e.g. the union of the matched leaves
    config: RasterizeConfig = RasterizeConfig(),
    *,
    payload_rgb: bool = True,
    better_vis: bool = True,
) -> RenderOutputs:
    """Render one explicit subset of splats (text and click selection;
    reference gaussian_renderer/__init__.py:276-356 with selected_leaf_id):
    the alive splats of select_mask (with better_vis, only those that pass
    the leaf-level scale cull, `passes_scale_cull`), as degree-3 SH color
    over bg or, with payload_rgb False, as the encoded instance feature over
    [bg, bg]. The selection is valid with at least SELECTION_MIN_POINTS
    splats. The caller applies the KNN outlier mask
    (ops/knn.selection_mask) on the host. -> RenderOutputs with
    cluster_imgs [H, W, C], cluster_silhouettes [H, W] and 0-d
    cluster_occur / cluster_valid."""
    camera = camera.to(gs.device)
    if payload_rgb:
        payload = sh_to_rgb(3, gs.sh, gs.means, camera.cam_center)
        fbg = bg
    else:
        payload = encoded_ins_feat(gs)
        fbg = torch.cat([bg, bg])
    keep = torch.as_tensor(select_mask, device=gs.device) & gs.alive
    if better_vis:
        keep = keep & passes_scale_cull(gs)
    cov3d = build_cov3d(gs.scales, gs.quats)
    out = _render_groups(camera, gs, keep[None, :], payload, fbg, cov3d, config,
                         SELECTION_MIN_POINTS)
    return dataclasses.replace(
        out, cluster_imgs=out.cluster_imgs[0],
        cluster_silhouettes=out.cluster_silhouettes[0],
        cluster_occur=out.cluster_occur[0], cluster_valid=out.cluster_valid[0])


def passes_scale_cull(gs: GaussianState) -> torch.Tensor:
    """[N] bool: the splats smaller than LEAF_SCALE_LIMIT on every axis, those
    render_selection's better_vis keeps."""
    return torch.all(gs.scales < LEAF_SCALE_LIMIT, dim=-1)


def save_selection(path: str, img: torch.Tensor) -> None:
    """An [H, W, 3] render_selection image in [0, 1] as an 8-bit PNG."""
    from PIL import Image

    arr = np.clip(img.cpu().numpy(), 0, 1)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _render_groups(camera, gs: GaussianState, keep, payload, fbg, cov3d,
                   config: RasterizeConfig, min_points: int,
                   frozen: FrozenPlan | None = None) -> RenderOutputs:
    """The groups of `keep` [G, N] over the background fbg: one after the
    other (group_render "auto"/"scan"), over one union binning ("dense"),
    or, with a FrozenPlan, one masked-opacity blend per group over the
    plan's stream."""
    opac = torch.where(keep, gs.opacity[None, :], 0.0)
    if frozen is not None:
        outs = [rasterize(camera, gs.means, cov3d, o, payload, fbg, config, frozen=frozen)
                for o in opac]
        r = RasterOut(
            image=torch.stack([x.image for x in outs]),
            alpha=torch.stack([x.alpha for x in outs]),
            depth=torch.stack([x.depth for x in outs]),
            radii=torch.stack([x.radii for x in outs]).max(dim=0).values,
            n_dropped=sum(x.n_dropped for x in outs),
            n_truncated=sum(x.n_truncated for x in outs))
    else:
        groups = rasterize_groups if config.group_render == "dense" else rasterize_scan_groups
        r = groups(camera, gs.means, cov3d, opac, payload, fbg, config)
    return _cluster_outputs(r, keep.sum(dim=-1), min_points)
