"""The geometry layer's hand-written CUDA kernels (csrc/geometry.cu) and
their plain versions.

  * `cov3d_fwd` / `cov3d_bwd`: Sigma = (R S)(R S)^T from scales and
    quaternions, and the gradients of both from Sigma's.
  * `project_fwd` / `project_bwd`: the EWA projection of `project`, every
    field of `Projected` written directly, and the gradients of the means,
    Sigma and the screen tap from those of mean2d, conic and depth (the only
    fields with a gradient).
  * `sh_fwd` / `sh_bwd`: the clamped SH colour of `sh_to_rgb` at degree 0-4,
    and the gradients of the coefficients and the means (through the view
    direction).

None of them replaces a Pallas kernel: the JAX package leaves this math to
XLA's fusion. Each kernel recomputes its forward's intermediates from the
forward's inputs, so the Functions below save their inputs alone.

`Cov3d`, `Project` and `ShColor` are the autograd Functions through which
`projection.build_cov3d`, `projection.project` and `sh.sh_to_rgb` run CUDA
tensors; CPU tensors run the plain forwards (`build_cov3d_plain`,
`project_plain`, `sh_to_rgb_plain`) with autograd through their ops, and
no Function. Each wrapper here dispatches on the device of its inputs, as
the rasterizer's do (ops/rasterize_kernels.py): a CPU tensor runs the plain
version (the plain forward, or the analytic `*_bwd_plain`), a CUDA tensor
launches the kernel or raises, never falling back. Each wrapper counts its
kernel's launches in `<wrapper>.launches`. The kernels take float32, the
camera's tensors on the splats' device, and SH coefficients of 3 channels.
"""

from __future__ import annotations

import dataclasses

import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops import projection as P
from opengaussian_tpu_torch.ops import sh as S

MAX_SH_DEGREE = 4


def _launch(name: str, device: torch.device, *args) -> None:
    # imported here: rasterize_kernels lists this module's wrappers
    from opengaussian_tpu_torch.ops.rasterize_kernels import _launch as launch

    launch(name, device, *args)


def _device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def _check(name: str, dev: torch.device, **tensors) -> None:
    for nm, x in tensors.items():
        if x is None:
            continue
        if x.dtype != torch.float32:
            raise ValueError(f"{nm} must be float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{nm} is on {x.device}, {name}'s inputs on {dev}")


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _rows(x: torch.Tensor | None) -> tuple[torch.Tensor | None, int]:
    """A cotangent [N, w] or [N] as (tensor, row stride in floats), read in
    place where its rows are contiguous (a column block of one [N, F]
    buffer, as the blend's backward hands them)."""
    if x is None:
        return None, 0
    if x.dim() == 2 and x.stride(1) != 1 and x.shape[1] > 1:
        x = x.contiguous()
    return x, x.stride(0)


def _camera(camera: Camera, dev: torch.device) -> tuple[torch.Tensor, ...]:
    """The camera's R_w2c, t_w2c, fx, fy, as the kernels read them."""
    cam = (camera.R_w2c.contiguous(), camera.t_w2c.contiguous(), camera.fx, camera.fy)
    _check("the projection", dev, R_w2c=cam[0], t_w2c=cam[1], fx=cam[2], fy=cam[3])
    return cam


# ---------------------------------------------------------------------------
# covariance


def cov3d_fwd(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """scales [N,3] (activated), quats [N,4] (w, x, y, z) -> Sigma [N,3,3].
    CPU tensors run `projection.build_cov3d_plain`; CUDA tensors launch the
    kernel. `cov3d_fwd.launches` counts kernel launches."""
    if not _device("cov3d_fwd", scales):
        return P.build_cov3d_plain(scales, quats)
    scales, quats = scales.contiguous(), quats.contiguous()
    _check("cov3d_fwd", scales.device, scales=scales, quats=quats)
    n = scales.shape[0]
    cov = torch.empty((n, 3, 3), dtype=torch.float32, device=scales.device)
    if n == 0:
        return cov
    _launch("og_cov3d_fwd", scales.device, scales.data_ptr(), quats.data_ptr(), n,
            cov.data_ptr())
    cov3d_fwd.launches += 1
    return cov


cov3d_fwd.launches = 0


def cov3d_bwd_plain(scales, quats, d_cov):
    """The analytic gradients of build_cov3d_plain: d_cov [N,3,3] ->
    (d_scales [N,3], d_quats [N,4]). A zero quaternion gets gradient 0."""
    norm = torch.linalg.norm(quats, dim=-1, keepdim=True)
    den = norm + 1e-12
    qn = quats / den
    R = P.quat_to_rotmat(quats)
    L = R * scales[:, None, :]
    dL = (d_cov + d_cov.transpose(1, 2)) @ L  # Sigma = L L^T
    d_scales = (dL * R).sum(dim=1)
    dR = (dL * scales[:, None, :]).reshape(-1, 9)
    r, x, y, z = qn.unbind(-1)
    d = dR.unbind(-1)
    dq = 2.0 * torch.stack([
        -z * d[1] + y * d[2] + z * d[3] - x * d[5] - y * d[6] + x * d[7],
        y * d[1] + z * d[2] + y * d[3] - 2 * x * d[4] - r * d[5] + z * d[6] + r * d[7]
        - 2 * x * d[8],
        -2 * y * d[0] + x * d[1] + r * d[2] + x * d[3] + z * d[5] - r * d[6] + z * d[7]
        - 2 * y * d[8],
        -2 * z * d[0] - r * d[1] + x * d[2] + r * d[3] - 2 * z * d[4] + y * d[5] + x * d[6]
        + y * d[7],
    ], dim=-1)
    d_den = -(dq * qn).sum(dim=-1, keepdim=True) / den
    d_norm = torch.where(norm > 0, d_den / norm, 0.0)
    return d_scales, dq / den + quats * d_norm


def cov3d_bwd(scales, quats, d_cov):
    """(d_scales [N,3], d_quats [N,4]) from d_cov [N,3,3]. CPU tensors run
    `cov3d_bwd_plain`; CUDA tensors launch the kernel.
    `cov3d_bwd.launches` counts kernel launches."""
    if not _device("cov3d_bwd", scales):
        return cov3d_bwd_plain(scales, quats, d_cov)
    scales, quats, d_cov = scales.contiguous(), quats.contiguous(), d_cov.contiguous()
    _check("cov3d_bwd", scales.device, scales=scales, quats=quats, d_cov=d_cov)
    n = scales.shape[0]
    d_scales = torch.empty_like(scales)
    d_quats = torch.empty_like(quats)
    if n == 0:
        return d_scales, d_quats
    _launch("og_cov3d_bwd", scales.device, scales.data_ptr(), quats.data_ptr(),
            d_cov.data_ptr(), n, d_scales.data_ptr(), d_quats.data_ptr())
    cov3d_bwd.launches += 1
    return d_scales, d_quats


cov3d_bwd.launches = 0


class Cov3d(torch.autograd.Function):
    """build_cov3d on CUDA tensors: forward and backward are kernels."""

    @staticmethod
    def forward(ctx, scales, quats):
        ctx.save_for_backward(scales, quats)
        return cov3d_fwd(scales, quats)

    @staticmethod
    def backward(ctx, d_cov):
        return cov3d_bwd(*ctx.saved_tensors, d_cov)


# ---------------------------------------------------------------------------
# projection

PROJECTED_FIELDS = tuple(f.name for f in dataclasses.fields(P.Projected))


def project_fwd(means3d, cov3d, camera: Camera, opacities=None, screen_tap=None):
    """The fields of `Projected`, in its order, for means3d [N,3], cov3d
    [N,3,3], opacities [N] and screen_tap [N,2] (either may be None) under
    `camera` (on the splats' device). CPU tensors run
    `projection.project_plain`; CUDA tensors launch the kernel.
    `project_fwd.launches` counts kernel launches."""
    if not _device("project_fwd", means3d):
        p = P.project_plain(means3d, cov3d, camera, opacities, screen_tap)
        return tuple(getattr(p, f) for f in PROJECTED_FIELDS)
    dev = means3d.device
    means3d, cov3d = means3d.contiguous(), cov3d.contiguous()
    opacities = None if opacities is None else opacities.contiguous()
    screen_tap = None if screen_tap is None else screen_tap.contiguous()
    _check("project_fwd", dev, means3d=means3d, cov3d=cov3d, opacities=opacities,
           screen_tap=screen_tap)
    cam = _camera(camera, dev)
    n = means3d.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty((n, 2), **f32), torch.empty((n,), **f32), torch.empty((n, 3), **f32),
           torch.empty((n,), **i32), torch.empty((n,), **f32), torch.empty((n, 2), **i32),
           torch.empty((n, 2), **i32), torch.empty((n,), **i32),
           torch.empty((n,), dtype=torch.bool, device=dev))
    if n == 0:
        return out
    _launch("og_project_fwd", dev, means3d.data_ptr(), cov3d.data_ptr(),
            *(x.data_ptr() for x in cam), _ptr(opacities), _ptr(screen_tap), n,
            camera.width, camera.height, *(x.data_ptr() for x in out))
    project_fwd.launches += 1
    return out


project_fwd.launches = 0


def project_bwd_plain(means3d, cov3d, camera: Camera, d_mean2d=None, d_conic=None,
                      d_depth=None, with_tap: bool = False):
    """The analytic gradients of project_plain: the cotangents of mean2d
    [N,2], conic [N,3] and depth [N] (None: zero) -> (d_means3d [N,3],
    d_cov3d [N,3,3], d_screen_tap [N,2] or None without with_tap). The
    other fields carry no gradient. The gradient rules are autograd's on
    the plain ops: the guard band's clamp passes it where -lim <= x <= lim,
    det gets none where det <= 0, the depth divisor none behind the near
    plane."""
    n = means3d.shape[0]
    zeros = means3d.new_zeros
    g_mean2d = zeros((n, 2)) if d_mean2d is None else d_mean2d
    g_conic = zeros((n, 3)) if d_conic is None else d_conic
    g_depth = zeros((n,)) if d_depth is None else d_depth
    R = camera.R_w2c
    t = means3d @ R.T + camera.t_w2c
    in_front = t[:, 2] > P.NEAR_Z
    tz_safe = torch.where(in_front, t[:, 2], 1.0)
    tanx, tany = camera.tanfovx, camera.tanfovy
    limx, limy = 1.3 * tanx, 1.3 * tany
    xz, yz = t[:, 0] / tz_safe, t[:, 1] / tz_safe
    txz = torch.clamp(xz, -limx, limx)
    tyz = torch.clamp(yz, -limy, limy)
    fx, fy = camera.fx, camera.fy
    inv_z = 1.0 / tz_safe
    j00, j02 = fx * inv_z, -fx * txz * inv_z
    j11, j12 = fy * inv_z, -fy * tyz * inv_z
    M0 = j00[:, None] * R[0] + j02[:, None] * R[2]
    M1 = j11[:, None] * R[1] + j12[:, None] * R[2]
    MS0 = (cov3d * M0[:, None, :]).sum(-1)  # MS[a][j] = sum_k M[a][k] Sigma[j][k]
    MS1 = (cov3d * M1[:, None, :]).sum(-1)
    c00 = (MS0 * M0).sum(-1) + P.DILATION
    c01 = (MS0 * M1).sum(-1)
    c11 = (MS1 * M1).sum(-1) + P.DILATION
    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    ga, gb, gc = g_conic.unbind(-1)
    d_inv_det = ga * c11 - gb * c01 + gc * c00
    d_det = torch.where(det_ok, -d_inv_det * inv_det * inv_det, 0.0)
    d_c00 = gc * inv_det + d_det * c11
    d_c01 = -gb * inv_det - 2.0 * c01 * d_det
    d_c11 = ga * inv_det + d_det * c00
    dMS0 = d_c00[:, None] * M0 + d_c01[:, None] * M1
    dMS1 = d_c11[:, None] * M1
    d_cov = M0[:, None, :] * dMS0[:, :, None] + M1[:, None, :] * dMS1[:, :, None]
    dM0 = d_c00[:, None] * MS0 + (dMS0[:, :, None] * cov3d).sum(1)
    dM1 = d_c01[:, None] * MS0 + d_c11[:, None] * MS1 + (dMS1[:, :, None] * cov3d).sum(1)
    d_j00, d_j02 = (dM0 * R[0]).sum(-1), (dM0 * R[2]).sum(-1)
    d_j11, d_j12 = (dM1 * R[1]).sum(-1), (dM1 * R[2]).sum(-1)
    d_inv_z = fx * d_j00 - fx * txz * d_j02 + fy * d_j11 - fy * tyz * d_j12
    d_xz = torch.where((xz >= -limx) & (xz <= limx), -fx * inv_z * d_j02, 0.0)
    d_yz = torch.where((yz >= -limy) & (yz <= limy), -fy * inv_z * d_j12, 0.0)
    d_ndc = torch.stack([g_mean2d[:, 0] * 0.5 * camera.width,
                         g_mean2d[:, 1] * 0.5 * camera.height], dim=-1)
    d_xz = d_xz + d_ndc[:, 0] / tanx
    d_yz = d_yz + d_ndc[:, 1] / tany
    d_tz_safe = -(d_xz * xz + d_yz * yz) / tz_safe - d_inv_z * inv_z * inv_z
    dt = torch.stack([d_xz / tz_safe, d_yz / tz_safe,
                      g_depth + torch.where(in_front, d_tz_safe, 0.0)], dim=-1)
    return dt @ R, d_cov, d_ndc if with_tap else None


def project_bwd(means3d, cov3d, camera: Camera, d_mean2d=None, d_conic=None,
                d_depth=None, with_tap: bool = False):
    """(d_means3d [N,3], d_cov3d [N,3,3], d_screen_tap [N,2] or None) from
    the cotangents of mean2d, conic and depth (None: zero; read in place at
    their row stride). CPU tensors run `project_bwd_plain`; CUDA tensors
    launch the kernel. `project_bwd.launches` counts kernel launches."""
    if not _device("project_bwd", means3d):
        return project_bwd_plain(means3d, cov3d, camera, d_mean2d, d_conic, d_depth,
                                 with_tap)
    dev = means3d.device
    means3d, cov3d = means3d.contiguous(), cov3d.contiguous()
    (g_m, s_m), (g_c, s_c), (g_d, s_d) = _rows(d_mean2d), _rows(d_conic), _rows(d_depth)
    _check("project_bwd", dev, means3d=means3d, cov3d=cov3d, d_mean2d=g_m, d_conic=g_c,
           d_depth=g_d)
    cam = _camera(camera, dev)
    n = means3d.shape[0]
    d_means = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_cov = torch.empty((n, 3, 3), dtype=torch.float32, device=dev)
    d_tap = torch.empty((n, 2), dtype=torch.float32, device=dev) if with_tap else None
    if n == 0:
        return d_means, d_cov, d_tap
    _launch("og_project_bwd", dev, means3d.data_ptr(), cov3d.data_ptr(),
            *(x.data_ptr() for x in cam), _ptr(g_m), s_m, _ptr(g_c), s_c, _ptr(g_d), s_d,
            n, camera.width, camera.height, d_means.data_ptr(), d_cov.data_ptr(),
            _ptr(d_tap))
    project_bwd.launches += 1
    return d_means, d_cov, d_tap


project_bwd.launches = 0


class Project(torch.autograd.Function):
    """project on CUDA tensors: forward and backward are kernels. Only
    mean2d, depth and conic carry gradients; the camera carries none."""

    @staticmethod
    def forward(ctx, means3d, cov3d, camera: Camera, opacities, screen_tap):
        out = project_fwd(means3d, cov3d, camera, opacities, screen_tap)
        ctx.mark_non_differentiable(*out[3:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, cov3d)
        ctx.camera, ctx.with_tap = camera, screen_tap is not None
        return out

    @staticmethod
    def backward(ctx, d_mean2d, d_depth, d_conic, *_):
        means3d, cov3d = ctx.saved_tensors
        d_means, d_cov, d_tap = project_bwd(means3d, cov3d, ctx.camera, d_mean2d, d_conic,
                                            d_depth, ctx.with_tap)
        return d_means, d_cov, None, None, d_tap


# ---------------------------------------------------------------------------
# SH colour


def sh_fwd(deg: int, sh_coeffs, means, cam_center) -> torch.Tensor:
    """sh_coeffs [N,K,3] (K >= (deg+1)^2), means [N,3], cam_center [3] ->
    clamped rgb [N,3] at degree deg (0-4). CPU tensors run
    `sh.sh_to_rgb_plain`; CUDA tensors launch the kernel.
    `sh_fwd.launches` counts kernel launches."""
    if not _device("sh_fwd", means):
        return S.sh_to_rgb_plain(deg, sh_coeffs, means, cam_center)
    sh_coeffs, means, cam_center = _check_sh(deg, sh_coeffs, means, cam_center)
    n, K = sh_coeffs.shape[:2]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    if n == 0:
        return rgb
    _launch("og_sh_fwd", means.device, deg, sh_coeffs.data_ptr(), K, means.data_ptr(),
            cam_center.data_ptr(), n, rgb.data_ptr())
    sh_fwd.launches += 1
    return rgb


sh_fwd.launches = 0


def _check_sh(deg: int, sh_coeffs, means, cam_center):
    if not 0 <= deg <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be 0-{MAX_SH_DEGREE}, got {deg}")
    if sh_coeffs.dim() != 3 or sh_coeffs.shape[2] != 3 or sh_coeffs.shape[1] < (deg + 1) ** 2:
        raise ValueError(f"sh_coeffs must be [N, K >= {(deg + 1) ** 2}, 3], got "
                         f"{tuple(sh_coeffs.shape)}")
    sh_coeffs, means, cam_center = (x.contiguous() for x in (sh_coeffs, means, cam_center))
    _check("sh_to_rgb", means.device, sh_coeffs=sh_coeffs, means=means,
           cam_center=cam_center)
    return sh_coeffs, means, cam_center


def sh_basis_grad(deg: int, dirs: torch.Tensor, d_basis: torch.Tensor) -> torch.Tensor:
    """The gradient [N,3] by (x, y, z) of sum_j d_basis[:, j] basis_j(dirs)
    (sh.sh_basis's polynomials, the direction's components independent)."""
    x, y, z = dirs.unbind(-1)
    db = d_basis.unbind(-1)
    C1, C2, C3, C4 = S.C1, S.C2, S.C3, S.C4
    terms = []  # (j, d/dx, d/dy, d/dz); 0 where the polynomial lacks the variable
    if deg > 0:
        terms += [(1, 0, -C1, 0), (2, 0, 0, C1), (3, -C1, 0, 0)]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        terms += [
            (4, C2[0] * y, C2[0] * x, 0),
            (5, 0, C2[1] * z, C2[1] * y),
            (6, -2 * C2[2] * x, -2 * C2[2] * y, 4 * C2[2] * z),
            (7, C2[3] * z, 0, C2[3] * x),
            (8, 2 * C2[4] * x, -2 * C2[4] * y, 0),
        ]
    if deg > 2:
        terms += [
            (9, C3[0] * 6 * xy, C3[0] * 3 * (xx - yy), 0),
            (10, C3[1] * yz, C3[1] * xz, C3[1] * xy),
            (11, C3[2] * -2 * xy, C3[2] * (4 * zz - xx - 3 * yy), C3[2] * 8 * yz),
            (12, C3[3] * -6 * xz, C3[3] * -6 * yz, C3[3] * (6 * zz - 3 * xx - 3 * yy)),
            (13, C3[4] * (4 * zz - 3 * xx - yy), C3[4] * -2 * xy, C3[4] * 8 * xz),
            (14, C3[5] * 2 * xz, C3[5] * -2 * yz, C3[5] * (xx - yy)),
            (15, C3[6] * 3 * (xx - yy), C3[6] * -6 * xy, 0),
        ]
    if deg > 3:
        z7a, z7b = 7 * zz - 1, 7 * zz - 3
        terms += [
            (16, C4[0] * y * (3 * xx - yy), C4[0] * x * (xx - 3 * yy), 0),
            (17, C4[1] * 6 * xy * z, C4[1] * 3 * z * (xx - yy), C4[1] * y * (3 * xx - yy)),
            (18, C4[2] * y * z7a, C4[2] * x * z7a, C4[2] * 14 * xy * z),
            (19, 0, C4[3] * z * z7b, C4[3] * y * (21 * zz - 3)),
            (20, 0, 0, C4[4] * z * (140 * zz - 60)),
            (21, C4[5] * z * z7b, 0, C4[5] * x * (21 * zz - 3)),
            (22, C4[6] * 2 * x * z7a, C4[6] * -2 * y * z7a, C4[6] * 14 * z * (xx - yy)),
            (23, C4[7] * 3 * z * (xx - yy), C4[7] * -6 * xy * z, C4[7] * x * (xx - 3 * yy)),
            (24, C4[8] * 4 * x * (xx - 3 * yy), C4[8] * 4 * y * (yy - 3 * xx), 0),
        ]
    g = torch.zeros_like(dirs)
    for j, *partials in terms:
        g = g + torch.stack([torch.as_tensor(p, dtype=dirs.dtype, device=dirs.device)
                             .expand_as(x) for p in partials], dim=-1) * db[j][:, None]
    return g


def sh_bwd_plain(deg: int, sh_coeffs, means, cam_center, d_rgb):
    """The analytic gradients of sh_to_rgb_plain: d_rgb [N,3] -> (d_sh
    [N,K,3], zero past the coefficients in use; d_means [N,3]). The clamp at
    0 passes the gradient where rgb + 0.5 >= 0; the direction's norm passes
    none at a zero view vector."""
    v = means - cam_center
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    den = norm + 1e-12
    dirs = v / den
    k = (deg + 1) ** 2
    basis = S.sh_basis(deg, dirs)
    coeffs = sh_coeffs[:, :k, :]
    raw = torch.einsum("nk,nkc->nc", basis, coeffs) + 0.5
    g = torch.where(raw >= 0, d_rgb, 0.0)
    d_sh = torch.zeros_like(sh_coeffs)
    d_sh[:, :k] = basis[:, :, None] * g[:, None, :]
    d_dirs = sh_basis_grad(deg, dirs, (coeffs * g[:, None, :]).sum(-1))
    d_den = -(d_dirs * dirs).sum(-1, keepdim=True) / den
    return d_sh, d_dirs / den + v * torch.where(norm > 0, d_den / norm, 0.0)


def sh_bwd(deg: int, sh_coeffs, means, cam_center, d_rgb):
    """(d_sh [N,K,3], d_means [N,3]) from d_rgb [N,3] (read in place at its
    row stride). CPU tensors run `sh_bwd_plain`; CUDA tensors launch the
    kernel. `sh_bwd.launches` counts kernel launches."""
    if not _device("sh_bwd", means):
        return sh_bwd_plain(deg, sh_coeffs, means, cam_center, d_rgb)
    sh_coeffs, means, cam_center = _check_sh(deg, sh_coeffs, means, cam_center)
    g, s = _rows(d_rgb)
    _check("sh_bwd", means.device, d_rgb=g)
    n, K = sh_coeffs.shape[:2]
    d_sh = torch.empty_like(sh_coeffs)
    d_means = torch.empty_like(means)
    if n == 0:
        return d_sh, d_means
    _launch("og_sh_bwd", means.device, deg, sh_coeffs.data_ptr(), K, means.data_ptr(),
            cam_center.data_ptr(), g.data_ptr(), s, n, d_sh.data_ptr(), d_means.data_ptr())
    sh_bwd.launches += 1
    return d_sh, d_means


sh_bwd.launches = 0


class ShColor(torch.autograd.Function):
    """sh_to_rgb on CUDA tensors: forward and backward are kernels."""

    @staticmethod
    def forward(ctx, deg: int, sh_coeffs, means, cam_center):
        ctx.save_for_backward(sh_coeffs, means, cam_center)
        ctx.deg = deg
        return sh_fwd(deg, sh_coeffs, means, cam_center)

    @staticmethod
    def backward(ctx, d_rgb):
        sh_coeffs, means, cam_center = ctx.saved_tensors
        d_sh, d_means = sh_bwd(ctx.deg, sh_coeffs, means, cam_center, d_rgb)
        d_center = -d_means.sum(dim=0) if ctx.needs_input_grad[3] else None
        return None, d_sh, d_means, d_center


KERNEL_WRAPPERS = (cov3d_fwd, cov3d_bwd, project_fwd, project_bwd, sh_fwd, sh_bwd)
