"""Render orchestration: GaussianState -> RGB, depth and instance features.

Port of opengaussian_tpu/render/__init__.py:render (reference
gaussian_renderer/__init__.py:22-373): at most two rasterizer calls per
view, one for SH color at true scale and one 6-channel instance-feature
pass at the (optionally) rescaled scale. Cluster renders arrive with the
feature-stage slices of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import GaussianState
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from opengaussian_tpu_torch.ops.sh import sh_to_rgb


@dataclasses.dataclass(frozen=True)
class RenderOutputs:
    """The render modes of the JAX package's RenderOutputs that this path
    produces. None where a mode is off."""

    render: torch.Tensor | None = None  # [H,W,3]
    alpha: torch.Tensor | None = None  # [H,W]
    depth: torch.Tensor | None = None  # [H,W]
    silhouette: torch.Tensor | None = None  # [H,W] alpha of the feature pass
    ins_feat: torch.Tensor | None = None  # [H,W,6]
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
) -> RenderOutputs:
    """Render one view: the color pass and/or the instance-feature pass."""
    camera = camera.to(gs.device)
    scales = gs.scales * scale_modifier
    opac = gs.opacity
    out = RenderOutputs()

    if render_color:
        cov3d = build_cov3d(scales, gs.quats)
        rgb = sh_to_rgb(active_sh_degree, gs.sh, gs.means, camera.cam_center)
        r = rasterize(camera, gs.means, cov3d, opac, rgb, bg, config)
        out = dataclasses.replace(
            out, render=r.image, alpha=r.alpha, depth=r.depth, radii=r.radii,
            visibility_filter=r.radii > 0, n_lost=r.n_dropped + r.n_truncated,
        )

    if render_feat_map:
        feat = encoded_ins_feat(gs, quantized_feat, origin_feat)
        cov3d_f = build_cov3d(scales * rescale_factor, gs.quats)
        fbg = torch.cat([bg, bg])  # the reference applies the same 3-ch bg
        rf = rasterize(camera, gs.means, cov3d_f, opac, feat, fbg, config)
        lost = rf.n_dropped + rf.n_truncated
        out = dataclasses.replace(
            out, ins_feat=rf.image, silhouette=rf.alpha,
            n_lost=lost if out.n_lost is None else torch.maximum(out.n_lost, lost),
        )
        if out.radii is None:
            out = dataclasses.replace(out, radii=rf.radii,
                                      visibility_filter=rf.radii > 0)
    return out
