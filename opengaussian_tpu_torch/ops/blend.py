"""Front-to-back alpha compositing rules (port of opengaussian_tpu/ops/blend.py).

The classic diff-gaussian-rasterization blend walks splats front-to-back per
pixel with three data-dependent rules:

  1. alpha = min(0.99, opacity * exp(power)); skipped entirely if < 1/255,
  2. transmittance update T <- T * (1 - alpha),
  3. permanent early stop when the *candidate* update would bring
     T * (1 - alpha) below 1e-4 (the offending splat is NOT composited and T
     keeps its previous value).

The walk itself lives in ops/rasterize_kernels.py (CUDA kernel and its plain
version) and ops/oracle.py (the naive per-pixel reference).
"""

from __future__ import annotations

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def alpha_from_conic(mean2d, conic, opacity, pix) -> torch.Tensor:
    """Raw per-pixel alpha for splats, before the 0.99 clamp.

    mean2d [..., K, 2], conic [..., K, 3] (a,b,c), opacity [..., K],
    pix [..., P, 2] pixel coordinates -> alpha [..., K, P].

    power = -0.5*(a dx^2 + c dy^2) - b dx dy with d = mean2d - pix, exactly
    the quadratic form of the classic rasterizer.
    """
    dx = mean2d[..., 0:1] - pix[..., None, :, 0]  # [..., K, P]
    dy = mean2d[..., 1:2] - pix[..., None, :, 1]
    a = conic[..., 0:1]
    b = conic[..., 1:2]
    c = conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = opacity[..., None] * torch.exp(torch.clamp(power, max=0.0))
    # positive power => degenerate conic; the classic code skips it
    return torch.where(power <= 0.0, alpha, 0.0)
