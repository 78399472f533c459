"""Camera model (port of opengaussian_tpu/cameras.py).

A frozen dataclass of float32 tensors: the world-to-camera transform and
pinhole intrinsics in pixels. Same pixel mapping as the JAX package:
``fx = W/(2 tan(fovx/2))``, ``cx = (W-1)/2``, and
``x_cam = R_w2c @ x_world + t_w2c`` with +z looking forward (COLMAP and the
reference's ``getWorld2View2``).

The intrinsics are 0-d float32 tensors, not Python floats, so that derived
quantities (``tanfovx``, the projection's Jacobian) round in float32 exactly
as the JAX package's do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. Tensor fields live on one device; H/W are ints."""

    R_w2c: torch.Tensor  # [3,3]
    t_w2c: torch.Tensor  # [3]
    fx: torch.Tensor  # [] pixels
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.R_w2c.device

    def to(self, device) -> "Camera":
        if torch.device(device) == self.device:
            return self
        move = {f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **move)

    @property
    def cam_center(self) -> torch.Tensor:
        # x_cam = R x + t  =>  center = -R^T t
        return -self.R_w2c.T @ self.t_w2c

    # int / tensor would multiply by a rounded reciprocal; divide instead
    @property
    def tanfovx(self) -> torch.Tensor:
        return torch.full_like(self.fx, self.width) / (2.0 * self.fx)

    @property
    def tanfovy(self) -> torch.Tensor:
        return torch.full_like(self.fy, self.height) / (2.0 * self.fy)

    def world_to_cam(self, pts: torch.Tensor) -> torch.Tensor:
        """[N,3] world -> [N,3] camera coordinates."""
        return pts @ self.R_w2c.T + self.t_w2c

    @staticmethod
    def from_fov(R_w2c, t_w2c, fovx: float, fovy: float, width: int,
                 height: int, device="cpu") -> "Camera":
        """The reference's centered-projection pixel mapping:
        pix = ((ndc + 1) * S - 1) / 2 with ndc = x/(z*tan) ==> fx = S/(2 tan),
        cx = (S - 1)/2. Cameras are host data by default: the data loaders
        build them on the CPU and `render` moves them to the model."""
        return Camera(
            R_w2c=_f32(R_w2c, device),
            t_w2c=_f32(t_w2c, device),
            fx=_f32(fov2focal(fovx, width), device),
            fy=_f32(fov2focal(fovy, height), device),
            cx=_f32((width - 1) / 2.0, device),
            cy=_f32((height - 1) / 2.0, device),
            width=int(width),
            height=int(height),
        )

    @staticmethod
    def from_K(R_w2c, t_w2c, K, width: int, height: int,
               device="cpu") -> "Camera":
        K = np.asarray(K)
        return Camera(
            R_w2c=_f32(R_w2c, device),
            t_w2c=_f32(t_w2c, device),
            fx=_f32(K[0, 0], device),
            fy=_f32(K[1, 1], device),
            cx=_f32(K[0, 2], device),
            cy=_f32(K[1, 2], device),
            width=int(width),
            height=int(height),
        )
