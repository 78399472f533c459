"""The benchmark's scenes, made from the seed on the device.

A configuration file (`ogbench/configs/<name>.json`, key "scene") fixes
the sizes; the seed draws the splats and the ground truth. What the seed
does not change: the number of splats and of views, the frame, the poses,
the SAM masks. So every seed gives a scene of the same sizes, seen from the
same views, whose splats and images differ.

  * Splats (`make_splats`): the point cloud of the port's bench scene
    (`opengaussian_tpu_torch/tools/bench.py:workload_cloud`: x ~ N(0, 1.2),
    y ~ N(0, 0.9), z ~ U(2, 10)), `visible_frac` of them in front of the
    cameras and the rest mirrored behind (`tools/stage_bench.py:
    build_scene`). The scale of a splat is what 3DGS initialises it to, the
    root of the mean squared distance to its 3 nearest neighbours, drawn
    here from the distribution those distances have in a Poisson cloud of
    the local density (the k-th neighbour's ball holds a Gamma(k) volume of
    the density), times `scale` (the bench's calibrated 0.088), with a
    per-axis log-normal spread `log_scale_spread` (a trained scene's splats
    are anisotropic); orientations uniform; logit-opacities ~ N(0, 2) (the
    bench's); SH degree 3 with rest coefficients ~ N(0, 0.1)
    (chip_smoke.py:write_model_and_scene); colours and instance features
    ~ U[0, 1) (3DGS's and OpenGaussian's initialisation). The table is
    padded to a multiple of 4096 slots with dead splats, as the program's
    store is.
  * Views (`make_cameras`): `views` cameras on an orbit of radius
    `orbit_radius` about the cloud's centre (0, 0, orbit_radius), with yaws
    evenly spread over `yaw_span` and pitches over `pitch_span` in a
    golden-ratio sequence, so that every view sees the cloud.
  * Ground truth (`make_images`): uniform random images, the bench's.
  * SAM ids (`make_sam_ids`): a grid of `mask_grid` rows x columns of
    blocky masks, shifted from view to view, with an invalid border of
    `mask_border` rows (`tools/stage_bench.py:build_bundle`'s masks).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CAPACITY_MULTIPLE = 4096
SH_C0 = 0.28209479177387814


def capacity(n: int) -> int:
    return max(-(-n // CAPACITY_MULTIPLE) * CAPACITY_MULTIPLE, CAPACITY_MULTIPLE)


def _normal_pdf(x: torch.Tensor, sd: float) -> torch.Tensor:
    return torch.exp(-0.5 * (x / sd) ** 2) / (sd * math.sqrt(2.0 * math.pi))


def knn_mean_sq_dist(pts: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The mean squared distance to the 3 nearest neighbours of each point in
    the bench's density normalised to one point (a cloud of m points: this
    over m^(2/3)), from unit exponential draws e [n, 3] (the gaps between
    the neighbours' balls)."""
    rho = _normal_pdf(pts[:, 0], 1.2) * _normal_pdf(pts[:, 1], 0.9) / 8.0
    vol = torch.cumsum(e, 1) / (4.0 * math.pi * rho[:, None] / 3.0)  # [n, 3]
    return (vol ** (2.0 / 3.0)).mean(1)


def make_splats(sc: dict, gen: torch.Generator, device) -> dict:
    """The splat table, padded to `capacity`, as float32 (alive: bool)
    tensors on `device`: means, sh_dc, sh_rest, log_scales, quats,
    logit_opacity, ins_feat, alive."""
    n = int(sc["splats"])
    cap = capacity(n)
    dev = torch.device(device)

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    def rand(*s):
        return torch.rand(*s, generator=gen, device=dev)

    pts = torch.stack([randn(n) * 1.2, randn(n) * 0.9, 2.0 + 8.0 * rand(n)], -1)
    vf = float(sc["visible_frac"])
    hidden = rand(n) >= vf
    e = -torch.log1p(-rand(n, 3))  # unit exponentials
    n_vis = vf * n
    side = torch.where(hidden, n - n_vis, n_vis)
    dist2 = torch.clamp(knn_mean_sq_dist(pts, e) / side ** (2.0 / 3.0), min=1e-7)
    pts[:, 2] = torch.where(hidden, -pts[:, 2], pts[:, 2])
    log_s = 0.5 * torch.log(dist2) + math.log(float(sc["scale"]))
    log_scales = log_s[:, None] + float(sc["log_scale_spread"]) * randn(n, 3)
    quats = randn(n, 4)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    colours = rand(n, 3)
    sh_rest = float(sc["sh_rest_std"]) * randn(n, 15, 3)
    logit = float(sc["opacity_logit_std"]) * randn(n)
    feat = rand(n, 6)

    def pad(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=dev)
        out[:n] = x
        return out

    q = pad(quats)
    q[n:, 0] = 1.0
    alive = torch.zeros(cap, dtype=torch.bool, device=dev)
    alive[:n] = True
    return dict(means=pad(pts), sh_dc=pad(((colours - 0.5) / SH_C0)[:, None, :]),
                sh_rest=pad(sh_rest), log_scales=pad(log_scales), quats=q,
                logit_opacity=pad(logit, -10.0), ins_feat=pad(feat), alive=alive)


def _rot(yaw: float, pitch: float) -> np.ndarray:
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return rx @ ry


def make_cameras(sc: dict) -> list[dict]:
    """Each view's world-to-camera R [3, 3], t [3] (float32 numpy) and
    pinhole intrinsics (fx, fy, cx, cy floats; the centred mapping cx =
    (W - 1) / 2), width and height."""
    V, W, H = int(sc["views"]), int(sc["width"]), int(sc["height"])
    D = float(sc["orbit_radius"])
    fx = W / (2.0 * math.tan(float(sc["fovx"]) / 2.0))
    fy = H / (2.0 * math.tan(float(sc["fovy"]) / 2.0))
    golden = (math.sqrt(5.0) - 1.0) / 2.0
    cams = []
    for i in range(V):
        yaw = float(sc["yaw_span"]) * ((i + 0.5) / V - 0.5)
        pitch = float(sc["pitch_span"]) * ((i * golden) % 1.0 - 0.5)
        Rm = _rot(yaw, pitch)
        c = np.array([0.0, 0.0, D])
        t = c - Rm @ c  # the orbit's centre stays at depth D
        cams.append(dict(R=Rm.astype(np.float32), t=t.astype(np.float32),
                         fx=float(np.float32(fx)), fy=float(np.float32(fy)),
                         cx=float(np.float32((W - 1) / 2.0)),
                         cy=float(np.float32((H - 1) / 2.0)), width=W, height=H))
    return cams


def cameras_extent(cams: list[dict]) -> float:
    """1.1 x the largest distance of a camera centre from their mean (the
    NeRF++ normalisation 3DGS scales its position learning rate by)."""
    centres = np.stack([-c["R"].astype(np.float64).T @ c["t"] for c in cams])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max() * 1.1)


def make_images(sc: dict, gen: torch.Generator, device) -> np.ndarray:
    """[V, H, W, 3] float32 ground truth in host memory, drawn on the device
    one view at a time."""
    V, W, H = int(sc["views"]), int(sc["width"]), int(sc["height"])
    out = np.empty((V, H, W, 3), np.float32)
    for i in range(V):
        out[i] = torch.rand((H, W, 3), generator=gen, device=device).cpu().numpy()
    return out


def make_sam_ids(sc: dict, i: int) -> np.ndarray:
    """View i's SAM ids [H, W] int32: 1..rows*cols, 0 invalid."""
    W, H = int(sc["width"]), int(sc["height"])
    rows, cols = sc["mask_grid"]
    ox, oy = (i * 37) % max(W // cols, 1), (i * 23) % max(H // rows, 1)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ids = 1 + (((yy + oy) * rows // H) % rows) * cols + (((xx + ox) * cols // W) % cols)
    ids[: int(sc["mask_border"])] = 0
    return ids.astype(np.int32)


def max_masks(sc: dict) -> int:
    """The mask count the trainer pads to: the largest id, at least 8,
    rounded up to a multiple of 8."""
    rows, cols = sc["mask_grid"]
    return int(math.ceil(max(rows * cols, 8) / 8) * 8)


def packed_sam(ids: np.ndarray, level: int) -> np.ndarray:
    """[4, H, W] int16 packed SAM levels whose `level` decodes to ids (the
    levels below it hold no mask, so they offset nothing)."""
    packed = np.full((4,) + ids.shape, -1, np.int16)
    packed[level] = ids.astype(np.int16) - 1
    return packed
