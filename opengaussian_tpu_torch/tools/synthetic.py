"""Synthetic scenes with known ground truth, for the quality and convergence
runs (the scenes that the JAX package's tools/quality_run.py and
examples/synthetic_convergence.py build inline).

A scene is a few blobs of splats. Their ground-truth images are renders of
that known splat table (the port's sh_to_rgb, build_cov3d and rasterize:
K1 on the card), and training starts from a noisy, gray, sparse subsample
of its points. Every draw comes from numpy generators with the JAX scripts'
seeds and in their order, so both packages build the same scene; the
renders agree to the rasterizer's tolerance.

The quality scene also has per-view SAM ids (level 3) from a one-hot object
render, an orthonormal CLIP table (one unit vector per object) and the GT
object of every pixel of the held-out views, for the quality run's scores.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.data.dataset import Scene, View
from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.models.gaussians import GaussianState, create_from_pcd
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, RasterOut, rasterize
from opengaussian_tpu_torch.ops.sh import sh_to_rgb

# the quality scene's objects: center, base color
QUALITY_OBJECTS = (
    ((-0.8, -0.5, 4.0), (1.0, 0.25, 0.2)),
    ((0.8, -0.5, 4.2), (0.2, 1.0, 0.3)),
    ((-0.8, 0.5, 3.8), (0.25, 0.4, 1.0)),
    ((0.8, 0.5, 4.0), (1.0, 0.9, 0.2)),
)
# the convergence scene's three colored blobs
CONVERGENCE_OBJECTS = (
    ((0.0, 0.0, 4.0), (1.0, 0.2, 0.2)),
    ((-0.8, 0.3, 4.5), (0.2, 1.0, 0.3)),
    ((0.7, -0.4, 3.6), (0.25, 0.4, 1.0)),
)
FOVX, FOVY = 1.0, 0.8
SEED = 7  # the scene's draws
STATE_SEED = 1  # create_from_pcd's draws of the GT table


@dataclasses.dataclass(frozen=True)
class QualitySize:
    """The quality scene's size: image, views, GT splats, initial points
    and the rasterizer's per-tile cap."""

    width: int
    height: int
    n_views: int
    n_test: int
    n_gt: int
    n_init: int
    max_per_tile: int


QUALITY_FULL = QualitySize(320, 240, 20, 4, 2400, 900, 512)
QUALITY_FAST = QualitySize(160, 120, 6, 2, 600, 300, 256)  # the CPU size


@dataclasses.dataclass(frozen=True)
class ConvergenceSize:
    """The convergence scene's size: image, views (the last n_test held
    out), GT splats, initial points."""

    width: int
    height: int
    n_views: int
    n_test: int
    n_gt: int
    n_init: int


CONVERGENCE_FULL = ConvergenceSize(640, 480, 24, 4, 3000, 800)


def blob_points(rng: np.random.Generator, objects, per: int, sigma: float):
    """`per` points around each object's center, N(0, sigma), colored by
    its base color times U[0.6, 1). -> (points [n, 3], colors [n, 3] float32,
    object id [n])."""
    pts, cols, obj = [], [], []
    for oi, (center, color) in enumerate(objects):
        pts.append(rng.normal(0, sigma, (per, 3)) + np.asarray(center))
        cols.append(np.tile(color, (per, 1)) * rng.uniform(0.6, 1.0, (per, 1)))
        obj.append(np.full(per, oi))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(cols).astype(np.float32),
            np.concatenate(obj))


def gt_state(points: np.ndarray, colors: np.ndarray, scale: float, logit_opacity: float,
             device) -> GaussianState:
    """The GT splat table: create_from_pcd at capacity n (every splat
    alive), isotropic scale `scale`, logit-opacity `logit_opacity`."""
    n = len(points)
    gs = create_from_pcd(points, colors, capacity=n, seed=STATE_SEED, device=device)
    return dataclasses.replace(
        gs, log_scales=gs.log_scales * 0 + float(np.log(scale)),
        logit_opacity=torch.full((n,), logit_opacity, device=gs.device))


@torch.no_grad()
def render_gt(gs: GaussianState, cam: Camera, payload: torch.Tensor | None,
              rcfg: RasterizeConfig) -> RasterOut:
    """The GT table's render over a black background: its degree-3 SH color,
    or `payload` [n, C]."""
    cam = cam.to(gs.device)
    if payload is None:
        payload = sh_to_rgb(3, gs.sh, gs.means, cam.cam_center)
    cov = build_cov3d(gs.scales, gs.quats)
    bg = torch.zeros(payload.shape[1], device=gs.device)
    return rasterize(cam, gs.means, cov, gs.opacity, payload, bg, rcfg)


def _rotation_y(ang: float) -> np.ndarray:
    return np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                     [np.sin(ang), 0, np.cos(ang)]], np.float32)


def quality_pose(i: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """View i of n on the quality scene's arc (world-to-camera R, t)."""
    ang = 0.7 * (i / max(n - 1, 1) - 0.5)
    t = np.array([0.6 * np.sin(2 * ang), 0.1 * np.cos(3 * ang), 0.0], np.float32)
    return _rotation_y(ang), t


def convergence_pose(i: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """View i of n on the convergence scene's arc."""
    ang = 0.6 * (i / n - 0.5)
    t = np.array([0.8 * np.sin(ang * 2), 0.0, 0.2 * np.cos(ang)], np.float32)
    return _rotation_y(ang), t


@dataclasses.dataclass
class QualityScene:
    """The quality scene and what its scores need: the GT object of each GT
    splat, the objects' centers, the CLIP table (row 1 + o is object o's
    unit vector), each held-out view's GT object per pixel (-1 where no
    object covers it)."""

    scene: Scene
    rcfg: RasterizeConfig
    size: QualitySize
    gt_obj: np.ndarray
    centers: np.ndarray
    clip: np.ndarray
    test_masks: list[np.ndarray]


def quality_scene(size: QualitySize = QUALITY_FULL, device="cuda") -> QualityScene:
    """Four blob objects; GT images and SAM ids rendered from the GT table;
    every (n_views + n_test) // n_test-th view from view 4 on held out
    (llffhold style); a noisy, gray subsample of the GT points as the
    initial cloud."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    objects = QUALITY_OBJECTS
    n_obj = len(objects)
    pts, cols, gt_obj = blob_points(rng, objects, size.n_gt // n_obj, 0.22)
    gs = gt_state(pts, cols, 0.05, 2.5, dev)
    rcfg = RasterizeConfig(max_per_tile=size.max_per_tile, chunk=64)
    onehot = torch.as_tensor((gt_obj[:, None] == np.arange(n_obj)).astype(np.float32),
                             device=dev)
    # CLIP table rows are indexed by the absolute level-3 mask id
    # (utils/masks.clip_feat_slice); levels 0-2 are empty, so the level-3
    # slice is rows [1, n_obj + 1): orthonormal unit vectors
    clip = np.zeros((n_obj + 1, 512), np.float32)
    for oi in range(n_obj):
        clip[oi + 1, oi] = 1.0
    n_all = size.n_views + size.n_test
    views, gt_masks = [], []
    for i in range(n_all):
        cam = Camera.from_fov(*quality_pose(i, n_all), FOVX, FOVY, size.width, size.height)
        img = np.clip(render_gt(gs, cam, None, rcfg).image.cpu().numpy(), 0, 1)
        ow = render_gt(gs, cam, onehot, rcfg)
        covered = ow.alpha.cpu().numpy() > 0.5
        obj = ow.image.cpu().numpy().argmax(-1)
        sam = np.zeros((4, size.height, size.width), np.int16)
        sam[3] = np.where(covered, obj + 1, 0)  # 0 = void
        views.append(View(camera=cam, image_name=f"v{i:03d}", gt_image=img.astype(np.float32),
                          sam_mask=sam, clip_feats=clip))
        gt_masks.append(np.where(covered, obj, -1))
    test_idx = set(range(4, n_all, n_all // size.n_test))
    ii = rng.choice(size.n_gt, size.n_init, replace=False)
    scene = Scene(
        train_views=[v for i, v in enumerate(views) if i not in test_idx],
        test_views=[v for i, v in enumerate(views) if i in test_idx],
        points=pts[ii] + rng.normal(0, 0.04, (size.n_init, 3)).astype(np.float32),
        colors=np.full((size.n_init, 3), 0.5, np.float32),
        cameras_extent=2.0, source_path="synthetic_quality")
    return QualityScene(scene=scene, rcfg=rcfg, size=size, gt_obj=gt_obj,
                        centers=np.asarray([c for c, _ in objects], np.float32), clip=clip,
                        test_masks=[gt_masks[i] for i in sorted(test_idx)])


def convergence_scene(size: ConvergenceSize = CONVERGENCE_FULL,
                      device="cuda") -> tuple[Scene, RasterizeConfig]:
    """Three colored blobs, views on an arc (at full size 24 at 640x480, the
    last 4 held out), a noisy, gray subsample of the GT points (800 of
    3,000) as the initial cloud."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)
    objects = CONVERGENCE_OBJECTS
    pts, cols, _ = blob_points(rng, objects, size.n_gt // len(objects), 0.25)
    gs = gt_state(pts, cols, 0.04, 2.0, dev)
    rcfg = RasterizeConfig(max_per_tile=512, chunk=64)
    views = []
    for i in range(size.n_views):
        cam = Camera.from_fov(*convergence_pose(i, size.n_views), FOVX, FOVY, size.width,
                              size.height)
        img = np.clip(render_gt(gs, cam, None, rcfg).image.cpu().numpy(), 0, 1)
        views.append(View(camera=cam, image_name=f"v{i:02d}", gt_image=img.astype(np.float32)))
    n_init, n_train = size.n_init, size.n_views - size.n_test
    idx = rng.choice(size.n_gt, n_init, replace=False)
    scene = Scene(train_views=views[:n_train], test_views=views[n_train:],
                  points=pts[idx] + rng.normal(0, 0.05, (n_init, 3)).astype(np.float32),
                  colors=np.full((n_init, 3), 0.5, np.float32), cameras_extent=2.0,
                  source_path="synthetic")
    return scene, rcfg
