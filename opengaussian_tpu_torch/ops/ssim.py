"""SSIM with the 11x11 Gaussian window (sigma=1.5).

Port of opengaussian_tpu/ops/ssim.py (reference utils/loss_utils.py:33-73):
per-channel 'same' smoothing with zero padding, C1=0.01^2, C2=0.03^2.
Images are [H, W, C] in [0, 1].

The window is separable (outer(g, g)), and a zero-padded 'same' 1D
convolution is a product with a banded Toeplitz matrix, so each smoothing is
two plain matrix products, [H,W,C] x [W,W] then [H,H] x [H,W,C], as in the
JAX package. They run in float32: the caller keeps TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default), since
TF32 keeps about three decimal digits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def _gauss1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(length: int, window_size: int = 11,
                 sigma: float = 1.5) -> np.ndarray:
    """[length, length] banded Toeplitz B with B[i, j] = g[j - i + half]:
    (B @ x)[i] = sum_j g[j-i+half] x[j] == zero-padded 'same' 1D conv."""
    g = _gauss1d(window_size, sigma)
    half = window_size // 2
    m = np.zeros((length, length), np.float32)
    for k, gk in enumerate(g):
        off = k - half
        idx = np.arange(max(0, -off), min(length, length - off))
        m[idx, idx + off] = gk
    return m


@functools.lru_cache(maxsize=16)
def _band(length: int, device: torch.device, window_size: int,
          sigma: float) -> torch.Tensor:
    """_band_matrix on `device`, copied there once per (length, device)."""
    return torch.as_tensor(_band_matrix(length, window_size, sigma), device=device)


def _filter2d(img: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """Per-channel 'same' Gaussian smoothing of [H,W,C] as two products."""
    h, w, _ = img.shape
    bw = _band(w, img.device, window_size, sigma)
    bh = _band(h, img.device, window_size, sigma)
    t = torch.einsum("hwc,vw->hvc", img, bw)  # smooth along W
    return torch.einsum("hvc,uh->uvc", t, bh)  # smooth along H


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    mu1 = _filter2d(img1, window_size)
    mu2 = _filter2d(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(img1 * img1, window_size) - mu1_sq
    s2 = _filter2d(img2 * img2, window_size) - mu2_sq
    s12 = _filter2d(img1 * img2, window_size) - mu12
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean()
