"""Self-contained LPIPS (VGG16 feature distance) in PyTorch.

Port of opengaussian_tpu/eval/lpips.py (reference
lpipsPyTorch/modules/lpips.py:8-36, networks.py:36-96, utils.py:6-8), with
the same semantics:

  * z-score the input with mean (-.030, -.088, -.188), std (.458, .448, .450)
    (networks.py:41-44,52-53). The reference quirk stays: these constants
    come from richzhang's [-1,1] scaling layer, but the reference's
    metrics.py feeds [0,1] tensors straight in, so callers pass [0,1] images;
  * the VGG16 `features` trunk, tapped after the ReLUs of conv1_2, conv2_2,
    conv3_3, conv4_3 and conv5_3 (target_layers [4, 9, 16, 23, 30],
    networks.py:90-92), i.e. before each maxpool;
  * each tapped activation normalised over channels
    (x / (||x||_c + 1e-10), utils.py:6-8);
  * squared difference -> per-layer 1x1 "lin" weights to one channel ->
    spatial mean -> sum over the five layers (lpips.py:31-36).

The trunk runs on NCHW tensors with torch.nn.functional.conv2d in float32:
each call turns TF32 off for its own convolutions (cuDNN allows TF32 by
default on Ampere and later GPUs) and restores the caller's setting after.

The weights load from a local `.npz` in the JAX package's layout
(`conv{i}_w` HWIO, `conv{i}_b`, `lin{i}_w`), so one file serves both
packages; see `WEIGHTS_ENV` / `DEFAULT_WEIGHTS_PATH`.
`convert_torch_weights` writes that file from the torchvision `vgg16`
state dict and richzhang's `vgg.pth` lin weights, on a machine that has
them.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from opengaussian_tpu_torch.device import resolve_device

WEIGHTS_ENV = "OPENGS_LPIPS_WEIGHTS"
DEFAULT_WEIGHTS_PATH = os.path.expanduser(
    "~/.cache/opengaussian_tpu/lpips_vgg.npz"
)

# torchvision vgg16.features conv layout: 13 convs, taps after the ReLU of
# convs 1, 3, 6, 9, 12 (0-based), the reference's target_layers
VGG16_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
POOL_BEFORE = (2, 4, 7, 10)  # a 2x2 maxpool precedes these convs
TAP_AFTER = (1, 3, 6, 9, 12)  # 0-based conv indices whose ReLU is tapped
N_CHANNELS_LIST = (64, 128, 256, 512, 512)

_MEAN = (-0.030, -0.088, -0.188)
_STD = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in float32 (TF32 off) inside the block."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


def torch_weights(weights: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """The .npz arrays as float32 tensors on `device`, conv weights
    transposed from HWIO to torch's OIHW."""
    out = {}
    for k, v in weights.items():
        v = np.asarray(v, np.float32)
        if k.startswith("conv") and k.endswith("_w"):
            v = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        out[k] = torch.as_tensor(v, device=device)
    return out


def vgg16_features(x: torch.Tensor, weights: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    """x [B,3,H,W] z-scored input -> the five tapped activations."""
    taps = []
    for i in range(len(VGG16_CHANNELS)):
        if i in POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"], padding=1))
        if i in TAP_AFTER:
            taps.append(x)
    return taps


def _normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips_pair(x: torch.Tensor, y: torch.Tensor,
               weights: dict[str, torch.Tensor]) -> torch.Tensor:
    """LPIPS between two [B,3,H,W] images in [0,1] (what the reference's
    metrics.py feeds it). -> [B]."""
    with fp32_convolutions():
        mean = torch.tensor(_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(_STD, device=x.device).view(1, 3, 1, 1)
        fx = vgg16_features((x - mean) / std, weights)
        fy = vgg16_features((y - mean) / std, weights)
        total = torch.zeros(x.shape[0], device=x.device)
        for i, (ax, ay) in enumerate(zip(fx, fy)):
            d = (_normalize_activation(ax) - _normalize_activation(ay)) ** 2
            lin = weights[f"lin{i}_w"].view(1, -1, 1, 1)
            total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
    return total


class LPIPS:
    """LPIPS with fixed weights on one device."""

    def __init__(self, weights: dict[str, np.ndarray], device="cuda"):
        self.device = resolve_device(device)
        self.weights = torch_weights(weights, self.device)

    @torch.no_grad()
    def __call__(self, x, y) -> float:
        """x, y: [H,W,3] float in [0,1] (numpy arrays or tensors)."""
        def nchw(a):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=self.device).permute(2, 0, 1)[None]

        return float(lpips_pair(nchw(x), nchw(y), self.weights)[0])


def weights_path() -> str | None:
    p = os.environ.get(WEIGHTS_ENV, DEFAULT_WEIGHTS_PATH)
    return p if os.path.exists(p) else None


def load_weights(path: str | None = None) -> dict[str, np.ndarray] | None:
    path = path or weights_path()
    if path is None or not os.path.exists(path):
        return None
    data = np.load(path)
    return {k: data[k] for k in data.files}


_INSTANCES: dict = {}


def get_lpips(device="cuda") -> LPIPS | None:
    """LPIPS from the configured weights file, one per (file, device); None
    (with one loud warning) when no weights are present, never a silent
    skip."""
    dev = resolve_device(device)
    key = (weights_path(), str(dev))
    if key not in _INSTANCES:
        w = load_weights(key[0])
        if w is None:
            print(
                "[lpips] WARNING: no weights found (set "
                f"${WEIGHTS_ENV} or place the converted npz at "
                f"{DEFAULT_WEIGHTS_PATH}; see "
                "opengaussian_tpu_torch.eval.lpips.convert_torch_weights). "
                "LPIPS will be reported as null.",
                file=sys.stderr,
                flush=True,
            )
        _INSTANCES[key] = None if w is None else LPIPS(w, dev)
    return _INSTANCES[key]


def convert_torch_weights(vgg_state: dict, lin_state: dict,
                          out_path: str) -> None:
    """Convert torch state dicts to the npz this module loads.

    vgg_state: torchvision `vgg16(...).features.state_dict()`, keys like
    `0.weight` [Cout,Cin,3,3] at the module indices 0,2,5,7,10,...
    lin_state: richzhang v0.1 `vgg.pth` after the reference's key renaming
    (lpipsPyTorch/modules/utils.py:22-29): keys `{i}.1.weight` [1,C,1,1].
    """
    conv_module_idx = []
    idx = 0
    for i in range(len(VGG16_CHANNELS)):
        if i in POOL_BEFORE:
            idx += 1  # the maxpool module
        conv_module_idx.append(idx)
        idx += 2  # conv + relu

    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    out = {}
    for i, mi in enumerate(conv_module_idx):
        out[f"conv{i}_w"] = arr(vgg_state[f"{mi}.weight"]).transpose(2, 3, 1, 0)  # HWIO
        out[f"conv{i}_b"] = arr(vgg_state[f"{mi}.bias"])
    for i in range(5):
        out[f"lin{i}_w"] = arr(lin_state[f"{i}.1.weight"]).reshape(-1)  # [1,C,1,1]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **out)


def random_weights(seed: int = 0) -> dict[str, np.ndarray]:
    """Random (but well-scaled) weights, for tests and architecture checks;
    the same draws as the JAX package's random_weights(seed)."""
    rng = np.random.default_rng(seed)
    out = {}
    cin = 3
    for i, cout in enumerate(VGG16_CHANNELS):
        out[f"conv{i}_w"] = rng.normal(
            0, np.sqrt(2.0 / (9 * cin)), (3, 3, cin, cout)
        ).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        cin = cout
    for i, c in enumerate(N_CHANNELS_LIST):
        out[f"lin{i}_w"] = rng.uniform(0, 0.1, (c,)).astype(np.float32)
    return out
