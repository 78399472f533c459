"""Scene loading: COLMAP / Blender(ScanNet) -> train/test views.

Copy of opengaussian_tpu/data/dataset.py; views carry the port's torch
`Camera`, built on the CPU (render moves it to the model's device).

Host-side numpy equivalent of the reference's loading stack
(reference scene/dataset_readers.py + utils/camera_utils.py + scene/__init__.py):

  * source-type sniffing (sparse/ => COLMAP, transforms_train.json => Blender)
  * SAM-mask / CLIP-feature sidecars from language_features/<frame>_s.npy
    ([4, H, W] packed ids) and _f.npy ([num_mask, 512])
  * NeRF++ normalization -> cameras_extent
  * the -r resolution policy including the >1600px auto-cap and the
    SAM-mask stride-downsample + alignment rule
  * llffhold=8 train/test split when eval is on

Notable deviation: the reference's Blender reader swaps FovX/FovY when
`camera_angle_x` is present (dataset_readers.py:316-318, a fork transcription
slip that its own pipelines never exercise — ScanNet json has no
camera_angle_x and LeRF uses COLMAP); we assign them correctly.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
from PIL import Image

from opengaussian_tpu_torch.cameras import Camera, focal2fov, fov2focal
from opengaussian_tpu_torch.data import colmap, ply


@dataclasses.dataclass
class View:
    """One camera with its ground truth and sidecars (host arrays)."""

    camera: Camera
    image_name: str
    gt_image: np.ndarray  # [H,W,3] float32 in [0,1]
    gt_alpha_mask: np.ndarray | None = None  # [H,W]
    sam_mask: np.ndarray | None = None  # [4,H,W] packed level ids (int)
    clip_feats: np.ndarray | None = None  # [num_mask,512]
    K: np.ndarray | None = None  # full-resolution intrinsics (refiner use)


@dataclasses.dataclass
class Scene:
    train_views: list[View]
    test_views: list[View]
    points: np.ndarray  # [M,3] init point cloud
    colors: np.ndarray  # [M,3] in [0,1]
    cameras_extent: float
    source_path: str


def nerfpp_norm(w2c_list: list[tuple[np.ndarray, np.ndarray]]) -> float:
    """cameras_extent: 1.1 * diagonal of camera centers
    (reference getNerfppNorm, scene/dataset_readers.py:46-73)."""
    centers = np.stack([-R.T @ t for R, t in w2c_list], axis=0)
    avg = centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=1)
    return float(dist.max() * 1.1)


def _choose_resolution(orig_w, orig_h, resolution, resolution_scale=1.0):
    """reference utils/camera_utils.py:20-41."""
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _sidecar_paths(source_path: str, frame_stem: str):
    lf = os.path.join(source_path, "language_features")
    seg = os.path.join(lf, frame_stem + "_s.npy")
    feat = os.path.join(lf, frame_stem + "_f.npy")
    return (seg if os.path.exists(seg) else None,
            feat if os.path.exists(feat) else None)


def _load_sidecars(source_path: str, frame_stem: str):
    seg, feat = _sidecar_paths(source_path, frame_stem)
    sam = np.load(seg) if seg else None
    clip = np.load(feat) if feat else None
    return sam, clip


def _find_image(path: str) -> str | None:
    if os.path.exists(path):
        return path
    base, ext = os.path.splitext(path)
    alt = base + (".png" if ext.lower() == ".jpg" else ".jpg")
    return alt if os.path.exists(alt) else None


def _decode_pixels(ipath: str, w: int, h: int, blender_bg: int | None):
    """Decode + resize one image exactly like the eager path: optional
    Blender RGBA-over-bg compositing at ORIGINAL resolution
    (reference scene/dataset_readers.py:271-279), then the RGBA convert +
    LANCZOS resize of _build_view. -> (gt [h,w,3] f32, alpha [h,w] f32)."""
    img = Image.open(ipath)
    if blender_bg is not None and img.mode == "RGBA":
        a = np.asarray(img, np.float32) / 255.0
        rgb = a[..., :3] * a[..., 3:] + (blender_bg / 255.0) * (1 - a[..., 3:])
        img = Image.fromarray((rgb * 255).astype(np.uint8), "RGB")
    rgba = img.convert("RGBA").resize((w, h), Image.Resampling.LANCZOS)
    arr = np.asarray(rgba, np.float32) / 255.0
    return arr[..., :3], arr[..., 3]


def _build_view_lazy(
    R_w2c, t_w2c, fovx, fovy, ipath: str, image_name, sam_path, clip_path,
    resolution: int, K=None, blender_bg: int | None = None,
) -> View:
    """Lazy twin of _build_view (data/lazy.py): resolution policy and camera
    come from file HEADERS; pixels and SAM sidecars decode on access. The
    one unavoidable decode at build time: images whose header carries an
    alpha channel are decoded once (not retained) to apply the eager path's
    `any(alpha < 1)` has-alpha rule bit-for-bit."""
    from opengaussian_tpu_torch.data.lazy import LazyArray

    img = Image.open(ipath)  # PIL reads the header only
    orig_w, orig_h = img.size
    has_alpha_channel = img.mode in ("RGBA", "LA", "PA") and blender_bg is None
    img.close()
    w, h = _choose_resolution(orig_w, orig_h, resolution)
    sam_lazy = None
    if sam_path is not None:
        z = np.load(sam_path, mmap_mode="r")
        step = int(max(resolution, 1))
        sam_shape = z.shape[:1] + z[:, ::step, ::step].shape[1:]
        if h != sam_shape[1]:
            w, h = sam_shape[2], sam_shape[1]
        sam_lazy = LazyArray(
            lambda p=sam_path, s=step: np.load(p)[:, ::s, ::s],
            sam_shape, z.dtype,
        )
        del z
    gt_alpha = None
    if has_alpha_channel:
        # decode once, keep only the boolean verdict
        _, alpha = _decode_pixels(ipath, w, h, blender_bg)
        if (alpha < 1.0).any():
            gt_alpha = LazyArray(
                lambda p=ipath, W=w, H=h, bg=blender_bg:
                    _decode_pixels(p, W, H, bg)[1],
                (h, w), np.float32,
            )
    return View(
        camera=Camera.from_fov(R_w2c, t_w2c, fovx, fovy, w, h),
        image_name=image_name,
        gt_image=LazyArray(
            lambda p=ipath, W=w, H=h, bg=blender_bg:
                _decode_pixels(p, W, H, bg)[0],
            (h, w, 3), np.float32,
        ),
        gt_alpha_mask=gt_alpha,
        sam_mask=sam_lazy,
        clip_feats=np.load(clip_path) if clip_path else None,  # small table
        K=K,
    )


def _build_view(
    R_w2c, t_w2c, fovx, fovy, img: Image.Image, image_name, sam_mask, clip_feats,
    resolution: int, K=None,
) -> View:
    orig_w, orig_h = img.size
    w, h = _choose_resolution(orig_w, orig_h, resolution)
    # SAM masks are stride-downsampled; the image resolution is then forced
    # to match the mask (reference utils/camera_utils.py:45-53)
    if sam_mask is not None:
        step = int(max(resolution, 1))
        sam_mask = sam_mask[:, ::step, ::step]
        if h != sam_mask.shape[1]:
            w, h = sam_mask.shape[2], sam_mask.shape[1]
    rgba = img.convert("RGBA").resize((w, h), Image.Resampling.LANCZOS)
    arr = np.asarray(rgba, np.float32) / 255.0
    gt = arr[..., :3]
    alpha = arr[..., 3]
    gt_alpha = alpha if (alpha < 1.0).any() else None
    cam = Camera.from_fov(R_w2c, t_w2c, fovx, fovy, w, h)
    return View(
        camera=cam,
        image_name=image_name,
        gt_image=gt,
        gt_alpha_mask=gt_alpha,
        sam_mask=sam_mask,
        clip_feats=clip_feats,
        K=K,
    )


def read_colmap_scene(path: str, images: str = "images", eval_split: bool = False,
                      resolution: int = -1, llffhold: int = 8,
                      lazy: bool = False) -> Scene:
    sp = os.path.join(path, "sparse/0")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sp, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sp, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sp, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sp, "images.txt"))

    views = []
    w2c_list = []
    for im in imgs.values():
        intr = cams[im.camera_id]
        if intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
        elif intr.model == "PINHOLE":
            fx, fy = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"COLMAP camera model not handled: {intr.model} (undistort first)"
            )
        fovx = focal2fov(fx, intr.width)
        fovy = focal2fov(fy, intr.height)
        R = colmap.qvec2rotmat(im.qvec)
        t = im.tvec
        ipath = _find_image(os.path.join(path, images, os.path.basename(im.name)))
        if ipath is None:
            continue
        stem = os.path.splitext(os.path.basename(im.name))[0]
        if lazy:
            seg, feat = _sidecar_paths(path, stem)
            views.append(_build_view_lazy(
                R, t, fovx, fovy, ipath, stem, seg, feat, resolution))
        else:
            sam, clip = _load_sidecars(path, stem)
            img = Image.open(ipath)
            views.append(
                _build_view(R, t, fovx, fovy, img, stem, sam, clip, resolution)
            )
        w2c_list.append((R, t))
    views.sort(key=lambda v: v.image_name)

    if eval_split:
        train = [v for i, v in enumerate(views) if i % llffhold != 0]
        test = [v for i, v in enumerate(views) if i % llffhold == 0]
    else:
        train, test = views, []

    extent = nerfpp_norm([(v.camera.R_w2c.cpu().numpy(), v.camera.t_w2c.cpu().numpy()) for v in train])

    ply_path = os.path.join(sp, "points3D.ply")
    if os.path.exists(ply_path):
        pts, cols = ply.load_point_cloud(ply_path)
    else:
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sp, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sp, "points3D.txt"))
        pts, cols = xyz, rgb.astype(np.float64) / 255.0
    return Scene(train, test, pts, cols, extent, path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = False, resolution: int = -1,
                       extension: str = ".png", rng_seed: int = 0,
                       lazy: bool = False) -> Scene:
    """transforms_train/test.json reader, including the ScanNet flavor with
    per-frame K (reference readCamerasFromTransforms,
    scene/dataset_readers.py:219-322)."""

    def read_split(fname):
        views = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx_global = contents.get("camera_angle_x")
        for frame in contents["frames"]:
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
            w2c = np.linalg.inv(c2w)
            R, t = w2c[:3, :3], w2c[:3, 3]
            ipath = _find_image(os.path.join(path, frame["file_path"] + extension))
            if ipath is None:
                continue
            img = Image.open(ipath)
            if lazy:
                w, h = img.size
                img.close()
                K = None
                if "K" in frame:
                    K = np.array(frame["K"], np.float64)
                    fovx = focal2fov(K[0][0], w)
                    fovy = focal2fov(K[0][0], h)
                elif fovx_global is not None:
                    fovx = fovx_global
                    fovy = focal2fov(fov2focal(fovx, w), h)
                else:
                    fl = contents.get("fl_x", frame.get("fl_x"))
                    fovx = focal2fov(fl, w)
                    fovy = focal2fov(fl, h)
                stem = Path(frame["file_path"]).name
                seg, feat = _sidecar_paths(path, stem)
                views.append(_build_view_lazy(
                    R, t, fovx, fovy, ipath, stem, seg, feat, resolution,
                    K=K, blender_bg=(255 if white_background else 0)))
                continue
            # composite on bg if RGBA (reference :271-279)
            if img.mode == "RGBA":
                bg = 255 if white_background else 0
                a = np.asarray(img, np.float32) / 255.0
                rgb = a[..., :3] * a[..., 3:] + (bg / 255.0) * (1 - a[..., 3:])
                img = Image.fromarray((rgb * 255).astype(np.uint8), "RGB")
            w, h = img.size
            K = None
            if "K" in frame:
                K = np.array(frame["K"], np.float64)
                fl = K[0][0]
                fovx = focal2fov(fl, w)
                fovy = focal2fov(fl, h)
            elif fovx_global is not None:
                fovx = fovx_global
                fovy = focal2fov(fov2focal(fovx, w), h)
            else:
                fl = contents.get("fl_x", frame.get("fl_x"))
                fovx = focal2fov(fl, w)
                fovy = focal2fov(fl, h)
            stem = Path(frame["file_path"]).name
            sam, clip = _load_sidecars(path, stem)
            views.append(_build_view(R, t, fovx, fovy, img, stem, sam, clip, resolution, K=K))
        return views

    train = read_split("transforms_train.json")
    has_test = os.path.exists(os.path.join(path, "transforms_test.json"))
    if eval_split:
        # with no test split the reference evaluates on the train views
        test = read_split("transforms_test.json") if has_test else list(train)
    else:
        if has_test:
            train = train + read_split("transforms_test.json")
        test = []
    extent = nerfpp_norm([(v.camera.R_w2c.cpu().numpy(), v.camera.t_w2c.cpu().numpy()) for v in train])

    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pts, cols = ply.load_point_cloud(ply_path)
    else:
        # random 100k init inside the synthetic bounds (reference :340-350)
        rng = np.random.default_rng(rng_seed)
        pts = rng.random((100_000, 3)) * 2.6 - 1.3
        cols = rng.random((100_000, 3))
    return Scene(train, test, pts, cols, extent, path)


def load_scene(path: str, images: str = "images", white_background: bool = False,
               eval_split: bool = False, resolution: int = -1,
               lazy: bool = False) -> Scene:
    """Source-type sniffing (reference scene/__init__.py:43-49).

    lazy=True: views carry data/lazy.LazyArray fields that decode pixels and
    SAM sidecars from disk ON ACCESS, so host RSS holds one view instead of
    all V (SURVEY §7.2 M6). Pair with save_memory=True — the trainer streams
    a one-view window per step either way."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images, eval_split, resolution,
                                 lazy=lazy)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split,
                                  resolution, lazy=lazy)
    raise ValueError(f"Could not recognize scene type for {path}")
