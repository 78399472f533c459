"""The port's quality and convergence runs (opengaussian_tpu_torch/tools/)
against the JAX package's tools/quality_run.py and
examples/synthetic_convergence.py, on the CPU.

- The synthetic scenes (tools/synthetic.py) against the JAX scripts'
  inline code, copied here with the JAX package's functions: GT images
  within atol 3e-5 + rtol 1e-4, SAM ids, the initial cloud, the split and
  the CLIP table equal. One pixel of the quality scene at --fast size
  (view v005, x 17, y 50) is off by 1.7e-4: splat 127's alpha there sits at
  the 1/255 gate (0.0039215 against 0.0039216), and its projected center
  differs between the packages by 3 ulps (6e-6 px; the camera-space
  matmul's rounding), so one package composites it and the other does not.
  The test allows at most 0.01% of the pixels past the tolerance, each
  within 1e-3.
- `quality_run.run(fast=True, device="cpu")` end to end against the JAX
  script's --fast path, run live in a thread beside it, both at the --fast
  size (160x120, 6 + 2 views) on a longer schedule (LONG_FAST): at the
  script's own 160 iterations nothing densifies, stage 0 reads 17.1 dB and
  no query's silhouette meets its object (mIoU 0.0), so those figures hold
  nothing. On LONG_FAST both densify twice (300 -> 561 splats) and read
  stage-0 PSNR 27.28 dB, retrieval 0.5 and mIoU 0.113. Both take the same
  draws: the k-means++ seeds `feat[:k]` (as tests/test_torch_blocks.py
  does) and densification's split noise (as tests/test_torch_longrun.py
  does); the view order comes from each trainer's numpy generator with the
  same seed. Each query's selected leaves, point count and composition are
  then equal and the figures agree to rounding.
- `synthetic_convergence.run` on a cut scene (80x60, 40 iterations).
"""

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models.gaussians import create_from_pcd as jcreate_from_pcd
from opengaussian_tpu.ops.projection import build_cov3d as jbuild_cov3d
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu.ops.sh import sh_to_rgb as jsh_to_rgb
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.tools import quality_run, synthetic, synthetic_convergence

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_TOL = dict(atol=3e-5, rtol=1e-4)
CONV_SMALL = synthetic.ConvergenceSize(80, 60, 6, 2, 300, 100)
# stage 0 to 240 (densifications at 100 and 200: from it0 // 4 = 60 until
# 210), then stages 1, 2.1 and 2.2 to 300, 360 and 420
LONG_FAST = dict(it0=240, it1=300, it21=360, it22=420, dense_until=210)


def jax_quality_scene(size: synthetic.QualitySize):
    """tools/quality_run.py:70-156 (the JAX package's scene, inline there).
    -> (views, test_idx, init points, CLIP table, GT object per test pixel)."""
    W, H = size.width, size.height
    n_views, n_test, n_gt, n_init = size.n_views, size.n_test, size.n_gt, size.n_init
    rng = np.random.default_rng(7)
    objects = synthetic.QUALITY_OBJECTS
    per = n_gt // len(objects)
    pts, cols, gt_obj = [], [], []
    for oi, (center, color) in enumerate(objects):
        pts.append(rng.normal(0, 0.22, (per, 3)) + np.asarray(center))
        cols.append(np.tile(color, (per, 1)) * rng.uniform(0.6, 1.0, (per, 1)))
        gt_obj.append(np.full(per, oi))
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    gt_obj = np.concatenate(gt_obj)
    gt_state = jcreate_from_pcd(pts, cols, capacity=n_gt, seed=1)
    gt_state = dataclasses.replace(gt_state, log_scales=gt_state.log_scales * 0 + np.log(0.05),
                                   logit_opacity=jnp.full((n_gt,), 2.5))

    def pose(i, n):
        ang = 0.7 * (i / max(n - 1, 1) - 0.5)
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.array([0.6 * np.sin(2 * ang), 0.1 * np.cos(3 * ang), 0.0], np.float32)
        return R, t

    rcfg = JRaster(max_per_tile=size.max_per_tile, chunk=64)
    onehot = jnp.asarray((gt_obj[:, None] == np.arange(len(objects))).astype(np.float32))

    @jax.jit
    def gt_render(cam):
        rgb = jsh_to_rgb(3, gt_state.sh, gt_state.means, cam.cam_center)
        cov = jbuild_cov3d(gt_state.scales, gt_state.quats)
        o1 = jrasterize(cam, gt_state.means, cov, gt_state.opacity, rgb, jnp.zeros(3), rcfg)
        o2 = jrasterize(cam, gt_state.means, cov, gt_state.opacity, onehot,
                        jnp.zeros(len(objects)), rcfg)
        return o1.image, o2.image, o2.alpha

    n_obj = len(objects)
    clip = np.zeros((n_obj + 1, 512), np.float32)
    for oi in range(n_obj):
        clip[oi + 1, oi] = 1.0
    views, gt_masks = [], []
    for i in range(n_views + n_test):
        cam = JCamera.from_fov(*pose(i, n_views + n_test), 1.0, 0.8, W, H)
        img, ow, alpha = gt_render(cam)
        covered = np.asarray(alpha) > 0.5
        obj = np.asarray(ow).argmax(-1)
        sam = np.zeros((4, H, W), np.int16)
        sam[3] = np.where(covered, obj + 1, 0).astype(np.int16)
        views.append((f"v{i:03d}", np.clip(np.asarray(img), 0, 1).astype(np.float32), sam))
        gt_masks.append(np.where(covered, obj, -1))
    test_idx = set(range(4, n_views + n_test, (n_views + n_test) // n_test))
    ii = rng.choice(n_gt, n_init, replace=False)
    init = pts[ii] + rng.normal(0, 0.04, (n_init, 3)).astype(np.float32)
    return views, test_idx, init, clip, [gt_masks[i] for i in sorted(test_idx)]


def jax_convergence_scene(size: synthetic.ConvergenceSize):
    """examples/synthetic_convergence.py:22-59 at `size`. -> (GT images,
    initial points)."""
    rng = np.random.default_rng(7)
    n_gt = size.n_gt
    c = []
    for center, color in synthetic.CONVERGENCE_OBJECTS:
        pts = rng.normal(0, .25, (n_gt // 3, 3)) + center
        c.append((pts, np.tile(color, (n_gt // 3, 1)) * rng.uniform(.6, 1, (n_gt // 3, 1))))
    pts = np.concatenate([a for a, _ in c]).astype(np.float32)
    cols = np.concatenate([b for _, b in c]).astype(np.float32)
    gt_state = jcreate_from_pcd(pts, cols, capacity=n_gt, seed=1)
    gt_state = dataclasses.replace(gt_state, log_scales=gt_state.log_scales * 0 + np.log(0.04),
                                   logit_opacity=jnp.full((n_gt,), 2.0))

    def pose(i, n):
        ang = 0.6 * (i / n - 0.5)
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.array([0.8 * np.sin(ang * 2), 0.0, 0.2 * np.cos(ang)], np.float32)
        return R, t

    rcfg = JRaster(max_per_tile=512, chunk=64)
    imgs = []
    for i in range(size.n_views):
        cam = JCamera.from_fov(*pose(i, size.n_views), 1.0, 0.8, size.width, size.height)
        rgb = jsh_to_rgb(3, gt_state.sh, gt_state.means, cam.cam_center)
        out = jrasterize(cam, gt_state.means, jbuild_cov3d(gt_state.scales, gt_state.quats),
                         gt_state.opacity, rgb, jnp.zeros(3), rcfg)
        imgs.append(np.clip(np.asarray(out.image), 0, 1).astype(np.float32))
    init_idx = rng.choice(n_gt, size.n_init, replace=False)
    init = pts[init_idx] + rng.normal(0, 0.05, (size.n_init, 3)).astype(np.float32)
    return imgs, init


def images_close(got: np.ndarray, want: np.ndarray) -> int:
    """Hold an image to IMG_TOL but at the 1/255-gate flips of the module
    docstring: at most 0.01% of its pixels, each within 1e-3. -> the count
    of pixels past the tolerance."""
    bad = ~np.isclose(got, want, **IMG_TOL).all(axis=-1)
    assert bad.sum() <= 1e-4 * bad.size, bad.sum()
    np.testing.assert_allclose(got, want, atol=1e-3)
    return int(bad.sum())


@pytest.fixture(scope="module")
def quality_scenes():
    size = synthetic.QUALITY_FAST
    return synthetic.quality_scene(size, "cpu"), jax_quality_scene(size)


def test_quality_scene_images_match_jax(quality_scenes):
    """GT images within the rasterizer's tolerance (one gate flip allowed
    and counted: 1 pixel of 153,600 at this size)."""
    q, (views, *_r) = quality_scenes
    got = q.scene.train_views + q.scene.test_views
    got = sorted(got, key=lambda v: v.image_name)
    assert [v.image_name for v in got] == [name for name, _, _ in views]
    flips = sum(images_close(v.gt_image, img) for v, (_, img, _) in zip(got, views))
    assert flips <= 1


def test_quality_scene_sam_ids_match_jax(quality_scenes):
    """SAM ids (level 3, from the one-hot object render) and the GT object
    masks of the held-out views: different only where the one-hot render's
    argmax ties, on at most 0.1% of the pixels (0 at this size)."""
    q, (views, _t, _i, _c, masks) = quality_scenes
    got = {v.image_name: v.sam_mask for v in q.scene.train_views + q.scene.test_views}
    diff = sum(int((got[name] != sam).sum()) for name, _, sam in views)
    assert diff <= 1e-3 * len(views) * views[0][2][3].size
    for a, b in zip(q.test_masks, masks):
        assert (a != b).mean() <= 1e-3


def test_quality_scene_split_init_and_clip_equal(quality_scenes):
    """The llffhold-style split, the noisy sparse initial cloud, its gray
    colors and the orthonormal CLIP table equal the JAX script's."""
    q, (views, test_idx, init, clip, _m) = quality_scenes
    names = {v.image_name for v in q.scene.test_views}
    assert names == {views[i][0] for i in test_idx}
    assert len(q.scene.train_views) == len(views) - len(test_idx)
    np.testing.assert_array_equal(q.scene.points, init)
    np.testing.assert_array_equal(q.scene.colors, np.full_like(init, 0.5))
    np.testing.assert_array_equal(q.clip, clip)
    assert all(v.clip_feats is q.clip for v in q.scene.train_views)
    assert q.scene.cameras_extent == 2.0


def test_convergence_scene_matches_jax():
    """The convergence scene (cut to 80x60, 6 views, 300 GT splats): GT
    images and the initial cloud against examples/synthetic_convergence.py."""
    scene, rcfg = synthetic.convergence_scene(CONV_SMALL, "cpu")
    imgs, init = jax_convergence_scene(CONV_SMALL)
    views = scene.train_views + scene.test_views
    assert len(scene.test_views) == CONV_SMALL.n_test
    for v, img in zip(views, imgs):
        images_close(v.gt_image, img)
    np.testing.assert_array_equal(scene.points, init)
    assert rcfg.max_per_tile == 512


def split_noise(event: int, cap: int) -> np.ndarray:
    """The standard-normal draws of the split children at densification
    `event` (1, 2, ...): [2, cap, 3] float32."""
    return np.random.default_rng(1000 + event).standard_normal((2, cap, 3)).astype(np.float32)


def jax_fast_run(out: str, mp: pytest.MonkeyPatch, events: dict) -> dict:
    """The JAX script's --fast path (tools/quality_run.py, run as a script)
    on LONG_FAST: its OptimizationConfig takes LONG_FAST's iterations as the
    script derives them from its own, and its two `train(until=)` calls
    (60 and 160) go to it0 and it22. -> the script's JSON."""
    from opengaussian_tpu import config as jconfig
    from opengaussian_tpu.models import gaussians as JG
    from opengaussian_tpu.ops import kmeans as jkm
    from opengaussian_tpu.train import loop as jloop

    s, real_opt, real_train = LONG_FAST, jconfig.OptimizationConfig, jloop.Trainer.train
    j_densify, real_normal = JG.densify_and_prune, jax.random.normal

    def opt(**kw):
        return real_opt(**dict(kw, iterations=s["it22"], start_ins_feat_iter=s["it0"],
                               start_root_cb_iter=s["it1"], start_leaf_cb_iter=s["it21"],
                               densify_from_iter=s["it0"] // 4,
                               densify_until_iter=s["dense_until"],
                               leaf_update_fr=max(s["it22"] // 20, 5)))

    def densify(state, moments, stats, key, *a):
        events["jax"] += 1
        noise = jnp.asarray(split_noise(events["jax"], state.capacity))
        jax.random.normal = lambda *_a, **_k: noise  # the one draw of this call
        try:
            return j_densify(state, moments, stats, key, *a)
        finally:
            jax.random.normal = real_normal

    mp.setattr(jconfig, "OptimizationConfig", opt)
    mp.setattr(jloop.Trainer, "train", lambda self, until, log_every=200: real_train(
        self, {60: s["it0"], 160: s["it22"]}[until], log_every))
    mp.setattr(jkm, "init_centers_from_points", lambda f, w, k, *a: f[:k])
    mp.setattr(JG, "densify_and_prune", densify)
    path = os.path.join(out, "jax_fast.json")
    mp.setattr(sys, "argv", ["quality_run.py", "--fast", "--out", path])
    runpy.run_path(os.path.join(ROOT, "tools", "quality_run.py"), run_name="__main__")
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fast_run(tmp_path_factory):
    """The port's --fast quality run and the JAX script's, both on
    LONG_FAST from the same draws, the JAX one in a thread; the repo's
    QUALITY_r05.json hashed before and after."""
    ref = os.path.join(ROOT, "QUALITY_r05.json")
    digest = hashlib.sha256(open(ref, "rb").read()).hexdigest()
    out = str(tmp_path_factory.mktemp("quality"))
    events = {"port": 0, "jax": 0}
    t_densify = TG.densify_and_prune

    def port_densify(state, *a, generator=None, **kw):
        events["port"] += 1
        noise = torch.from_numpy(split_noise(events["port"], state.capacity))
        return t_densify(state, *a, noise=noise, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tkm, "init_centers_from_points", lambda f, w, k, *a: f[:k])
    mp.setattr(TG, "densify_and_prune", port_densify)
    mp.setattr(quality_run, "schedule", lambda fast: dict(LONG_FAST))
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(jax_fast_run, str(tmp_path_factory.mktemp("jax")), mp, events)
            res = quality_run.run(fast=True, device="cpu", out=out)
            jax_res = fut.result(timeout=900)
    finally:
        mp.undo()
    after = hashlib.sha256(open(ref, "rb").read()).hexdigest()
    return res, out, digest == after, jax_res, events


def test_quality_run_writes_every_key(fast_run):
    """Every key of QUALITY_r05.json, with the port's additions, into --out
    (not the repository's file, which stays as it was), and the PNG."""
    res, out, untouched = fast_run[:3]
    want = json.load(open(os.path.join(ROOT, "QUALITY_r05.json")))
    got = json.load(open(res["json"]))
    assert os.path.dirname(res["json"]) == out and os.path.isfile(res["png"])
    assert set(want) <= set(got), set(want) - set(got)
    assert set(want["workload"]) == set(got["workload"])
    assert got["workload"] == dict(width=160, height=120, n_train=7, n_test=1, n_gt_splats=600,
                                   objects=4, k1=4, k2=2, iters=LONG_FAST["it22"], fast=True)
    assert got["device"] == "cpu" and got["peak_device_mib"] is None
    assert got["trainer_options"] == dict(autotune_budgets=True, use_frozen_plans=True,
                                          BLOCK_SIZES=[])
    assert untouched


def test_quality_run_matches_jax_fast_run(fast_run):
    """The --fast figures against the JAX script's, run live from the same
    draws: both densify twice, and each query selects the same leaves with
    the same points; PSNR within 0.2 dB, L1 within 2%, alive within 1%
    (check b's bands), purity within 0.02, retrieval equal, mIoU within
    0.01 (a few pixels of the one held-out view flipping at the 0.7
    silhouette gate); no slot lost in any step."""
    res, j, events = fast_run[0], fast_run[3], fast_run[4]
    assert events == {"port": 2, "jax": 2}
    assert j["num_alive"] > 300 and j["text_retrieval_acc"] >= 0.5 and j["text_query_miou"] > 0.05
    for k in ("stage0_psnr", "final_psnr"):
        assert abs(res[k] - j[k]) <= 0.2, (k, res[k], j[k])
    assert abs(res["final_l1"] - j["final_l1"]) <= 0.02 * j["final_l1"]
    assert abs(res["num_alive"] - j["num_alive"]) <= 0.01 * j["num_alive"]
    for k in ("root_cluster_purity", "leaf_cluster_purity"):
        assert abs(res[k] - j[k]) <= 0.02, (k, res[k], j[k])
    for got, want in zip(res["retrieval_diagnostics"], j["retrieval_diagnostics"], strict=True):
        for k in ("selected_leaves", "n_points", "composition"):
            assert got[k] == want[k], (got, want)
    assert res["text_retrieval_acc"] == j["text_retrieval_acc"]
    assert abs(res["text_query_miou"] - j["text_query_miou"]) <= 0.01
    assert res["slots_lost"] == 0


def test_quality_run_scores_are_consistent(fast_run):
    """The stage-2.2 trajectory holds only stage-2.2 logged steps, per root,
    as the JAX script's does; one diagnostic per object, with one IoU per
    (object, held-out view)."""
    res, j = fast_run[0], fast_run[3]
    traj = res["stage22_loss_trajectory"]
    assert traj and all(LONG_FAST["it21"] < t["iteration"] <= LONG_FAST["it22"] for t in traj)
    assert [t["iteration"] for t in traj] == [t["iteration"] for t in j["stage22_loss_trajectory"]]
    assert sum(r["n"] for r in res["stage22_per_root_loss"].values()) == len(traj)
    assert [d["object"] for d in res["retrieval_diagnostics"]] == [0, 1, 2, 3]
    assert 0.0 <= res["text_query_miou"] <= 1.0 and res["wall_s"] > 0


def test_fast_schedule_is_the_jax_scripts():
    """--fast's schedule is the JAX script's --fast one (tools/quality_run.py:
    60, 90, 120, 160, densifying until 40), and the full one its 2,600
    iterations."""
    assert quality_run.schedule(True) == dict(it0=60, it1=90, it21=120, it22=160, dense_until=40)
    assert quality_run.schedule(False) == dict(it0=1400, it1=1900, it21=2200, it22=2600,
                                               dense_until=1100)


def test_purity_counts_majorities():
    """`purity` on a hand-made assignment: clusters of fewer than 3 alive
    splats are skipped."""
    cls = np.array([0, 0, 0, 1, 1, 1, 1, 2, 2])
    obj = np.array([0, 0, 1, 2, 2, 2, 0, 3, 3])
    alive = np.ones(9, bool)
    assert quality_run.purity(cls, 3, alive, obj, 4) == pytest.approx(5 / 7)
    alive[3] = False
    assert quality_run.purity(cls, 3, alive, obj, 4) == pytest.approx(4 / 6)


def test_convergence_run_smoke(tmp_path):
    """`synthetic_convergence.run` on the cut scene: the curve at 0 and 40
    iterations, PSNR rising, the held-out views' PSNR by view (their mean the
    curve's last point) and the training views', the PNG written, no slot
    lost."""
    res = synthetic_convergence.run(device="cpu", out=str(tmp_path), checkpoints=(40,),
                                    size=CONV_SMALL)
    assert [c["iteration"] for c in res["curve"]] == [0, 40]
    assert res["curve"][1]["psnr"] > res["curve"][0]["psnr"]
    assert len(res["test_psnr_by_view"]) == CONV_SMALL.n_test
    assert np.mean(res["test_psnr_by_view"]) == pytest.approx(res["curve"][1]["psnr"], abs=2e-3)
    assert res["train_psnr_min"] <= res["train_psnr"]
    assert res["curve"][1]["num_alive"] == CONV_SMALL.n_init
    assert os.path.isfile(res["png"]) and res["slots_lost"] == 0
    assert res["device"] == "cpu" and res["peak_device_mib"] is None
