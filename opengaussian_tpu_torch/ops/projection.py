"""Gaussian projection: 3D -> screen-space splats (EWA).

Port of opengaussian_tpu/ops/projection.py. Same math as the classic
diff-gaussian-rasterization `preprocess` kernel:

  * covariance from quaternion+scale:   Sigma = (R S)(R S)^T
  * near-plane cull at z <= 0.2
  * EWA 2D covariance  cov2d = J W Sigma W^T J^T  with the fov-clamped
    Jacobian and the +0.3 pixel dilation on the diagonal
  * conic (inverse cov2d), radius min(3 sigma, opacity-aware cutoff)
  * pixel-space center via the centered pinhole mapping
  * 16x16 tile rectangle per splat

The small 3x3 products are written out as elementwise multiply-adds in the
JAX package's order, so both packages round alike.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera

NEAR_Z = 0.2
DILATION = 0.3
TILE = 16

# float -> int32 conversions saturate here first, as XLA's do (a C cast of
# an out-of-range float is undefined)
_INT_SAT = float(2**30)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -_INT_SAT, _INT_SAT).to(torch.int32)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z), not necessarily normalized -> [..., 3, 3]."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, left to right."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """scales [N,3] (activated, positive), quats [N,4] -> Sigma [N,3,3]."""
    R = quat_to_rotmat(quats)
    L = R * scales[..., None, :]  # R @ diag(s)
    return _sum3(L[..., :, None, :] * L[..., None, :, :])


@dataclasses.dataclass(frozen=True)
class Projected:
    """Screen-space splats. All [N]-leading tensors."""

    mean2d: torch.Tensor  # [N,2] pixel coords of the center
    depth: torch.Tensor  # [N] camera-space z
    conic: torch.Tensor  # [N,3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] int32 pixel radius (0 => culled)
    cull_radius: torch.Tensor  # [N] f32: beyond this distance alpha < 1/255
    # is guaranteed (opacity-aware r_cut; 3.4e38 when opacity is unknown)
    rect_min: torch.Tensor  # [N,2] int32 inclusive tile coords (x, y)
    rect_max: torch.Tensor  # [N,2] int32 exclusive tile coords
    num_tiles: torch.Tensor  # [N] int32 tiles touched (0 => culled)
    valid: torch.Tensor  # [N] bool


def project(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    camera: Camera,
    opacities: torch.Tensor | None = None,
    screen_tap: torch.Tensor | None = None,
) -> Projected:
    """Project Gaussians to screen space.

    means3d [N,3] world-space centers, cov3d [N,3,3] world-space
    covariances, opacities [N] (enables the opacity-aware tight radius),
    screen_tap [N,2]: zeros added to the NDC position; its gradient is the
    screen-space positional gradient densification reads (the reference's
    `means2D` tap, gaussian_renderer/__init__.py:45-49)."""
    t = means3d @ camera.R_w2c.T + camera.t_w2c  # [N,3] camera space
    tz = t[..., 2]
    in_front = tz > NEAR_Z
    tz_safe = torch.where(in_front, tz, 1.0)

    # fov-clamped point for the Jacobian (classic EWA guard band of 1.3)
    tanfovx = camera.tanfovx
    tanfovy = camera.tanfovy
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txz = torch.clamp(t[..., 0] / tz_safe, -limx, limx)
    tyz = torch.clamp(t[..., 1] / tz_safe, -limy, limy)

    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / tz_safe
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z

    W = camera.R_w2c  # world->cam rotation
    M0 = j00[:, None] * W[0] + j02[:, None] * W[2]
    M1 = j11[:, None] * W[1] + j12[:, None] * W[2]
    M = torch.stack([M0, M1], dim=-2)  # [N,2,3]
    MS = _sum3(M[..., :, None, :] * cov3d[..., None, :, :])  # [N,2,3]
    cov2d = _sum3(MS[..., :, None, :] * M[..., None, :, :])  # [N,2,2]
    c00 = cov2d[..., 0, 0] + DILATION
    c01 = cov2d[..., 0, 1]
    c11 = cov2d[..., 1, 1] + DILATION

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    lam1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    cull_radius = torch.full_like(radius_f, 3.4e38)
    if opacities is not None:
        # Opacity-aware cutoff: beyond r_cut = sqrt(2*lam_max*ln(255*o))
        # every pixel's alpha is provably < 1/255, so the blend's skip rule
        # drops it anyway. Splats with opacity <= 1/255 never contribute.
        o = torch.clamp(opacities, min=0.0)
        can_hit = 255.0 * o >= 1.0
        r_cut = torch.sqrt(
            2.0 * torch.clamp(lam1, min=0.0)
            * torch.log(torch.clamp(255.0 * o, min=1.0))
        )
        radius_f = torch.where(can_hit, torch.minimum(radius_f, torch.ceil(r_cut)), 0.0)
        cull_radius = torch.where(can_hit, torch.ceil(r_cut), 0.0)
        in_front = in_front & can_hit

    # pixel center via NDC
    ndc_x = t[..., 0] / tz_safe / tanfovx
    ndc_y = t[..., 1] / tz_safe / tanfovy
    if screen_tap is not None:
        ndc_x = ndc_x + screen_tap[..., 0]
        ndc_y = ndc_y + screen_tap[..., 1]
    px = ((ndc_x + 1.0) * camera.width - 1.0) * 0.5
    py = ((ndc_y + 1.0) * camera.height - 1.0) * 0.5
    mean2d = torch.stack([px, py], dim=-1)

    # tile rectangle (integer plumbing)
    grid_x = (camera.width + TILE - 1) // TILE
    grid_y = (camera.height + TILE - 1) // TILE
    p = mean2d.detach()
    r = radius_f.detach()
    rx_min = torch.clamp(_to_i32((p[..., 0] - r) / TILE), 0, grid_x)
    ry_min = torch.clamp(_to_i32((p[..., 1] - r) / TILE), 0, grid_y)
    rx_max = torch.clamp(_to_i32((p[..., 0] + r + TILE - 1) / TILE), 0, grid_x)
    ry_max = torch.clamp(_to_i32((p[..., 1] + r + TILE - 1) / TILE), 0, grid_y)
    area = (rx_max - rx_min) * (ry_max - ry_min)
    valid = in_front & det_ok & (area > 0)
    radius_i = _to_i32(torch.where(valid, r, 0.0))
    num_tiles = torch.where(valid, area, 0).to(torch.int32)

    return Projected(
        mean2d=mean2d,
        depth=tz,
        conic=conic,
        radius=radius_i,
        cull_radius=cull_radius.detach(),
        rect_min=torch.stack([rx_min, ry_min], dim=-1),
        rect_max=torch.stack([rx_max, ry_max], dim=-1),
        num_tiles=num_tiles,
        valid=valid,
    )


def clip_rect_rows(proj: Projected, row_lo: int, row_hi: int) -> Projected:
    """proj with each splat's tile rect clipped to grid rows [row_lo, row_hi)
    (the JAX package's clip_rect_rows).

    Banded binning (parallel/render.py): each rank clips the gathered table
    to its own tile rows before the expansion, so its slot stream holds only
    its band's slots. Pixel-exact: the slots outside the rows belong to other
    bands, and each slot inside still takes the circle-tile cull. A splat
    whose rect misses the band, or that is invalid, gets num_tiles 0 and is
    never expanded."""
    ry_min = torch.clamp(proj.rect_min[:, 1], min=row_lo)
    ry_max = torch.clamp(proj.rect_max[:, 1], max=row_hi)
    h = torch.clamp(ry_max - ry_min, min=0)
    area = (proj.rect_max[:, 0] - proj.rect_min[:, 0]) * h
    return dataclasses.replace(
        proj,
        rect_min=torch.stack([proj.rect_min[:, 0], torch.minimum(ry_min, ry_max)], dim=-1),
        rect_max=torch.stack([proj.rect_max[:, 0], ry_max], dim=-1),
        num_tiles=torch.where(proj.valid, area, 0).to(torch.int32),
    )
