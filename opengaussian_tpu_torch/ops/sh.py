"""Real spherical harmonics evaluation, degrees 0..4 (port of
opengaussian_tpu/ops/sh.py; reference utils/sh_utils.py:57-118).

Coefficient layout is [..., K, C] (K = (deg+1)^2 basis functions, C
channels), matching the parameter store's ``sh_dc [N,1,3]`` /
``sh_rest [N,15,3]`` split.

`sh_to_rgb` dispatches on the device of its inputs: CPU tensors run
`sh_to_rgb_plain` with autograd through its ops; CUDA tensors [N, K, 3] run
the SH colour kernel (ops/geometry_kernels.py, csrc/geometry.cu), which
evaluates the basis in registers, forward and backward each one launch, or
raise.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)^2] basis values."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg > 2:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg > 3:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh_coeffs [..., K, C], dirs [..., 3] -> [..., C]. Only the first
    (deg+1)^2 coefficients participate."""
    k = (deg + 1) ** 2
    basis = sh_basis(deg, dirs)  # [..., k]
    return torch.einsum("...k,...kc->...c", basis, sh_coeffs[..., :k, :])


def sh_to_rgb(deg: int, sh_coeffs, means, cam_center) -> torch.Tensor:
    """SH -> clamped RGB as the rasterizer does it: evaluate along the
    normalized view direction, add 0.5, clamp at 0 from below. CPU tensors
    run `sh_to_rgb_plain`; CUDA tensors the SH colour kernel, forward and
    backward (`geometry_kernels.ShColor`)."""
    if means.device.type == "cpu":
        return sh_to_rgb_plain(deg, sh_coeffs, means, cam_center)
    from opengaussian_tpu_torch.ops.geometry_kernels import ShColor  # imports this module

    return ShColor.apply(deg, sh_coeffs, means, cam_center)


def sh_to_rgb_plain(deg: int, sh_coeffs, means, cam_center) -> torch.Tensor:
    """sh_to_rgb in plain PyTorch ops."""
    dirs = means - cam_center
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = eval_sh(deg, sh_coeffs, dirs) + 0.5
    return torch.clamp(rgb, min=0.0)


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_dc_to_rgb(sh_dc):
    return sh_dc * C0 + 0.5
