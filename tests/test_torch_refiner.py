"""The port's SAM mask refiner (refine/sam_refiner.py, refine/introspect.py,
the trainer's hook and cli/vis_refinement.py) against the JAX package's.

Both packages get the same numpy-seeded state (models/gaussians.py:
state_from_numpy) and cameras. The JAX side runs its plain XLA path, as its
own refiner tests do on the CPU; the port runs the plain versions of its
kernels. Votes and weights agree to atol 1e-5 + rtol 1e-4; the refined masks
are equal, ids included: the id minting is the same host code.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops.projection import build_cov3d as jbuild_cov3d
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu.refine import sam_refiner as jref
from opengaussian_tpu.refine.introspect import RefinerTrace as JTrace
from opengaussian_tpu_torch.cameras import Camera as TCamera
from opengaussian_tpu_torch.cli import vis_refinement as tcli_vis
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.refine import sam_refiner as tref
from opengaussian_tpu_torch.refine.introspect import RefinerTrace as TTrace
from opengaussian_tpu_torch.train import loop as tloop
from tests import test_refiner, test_refiner_golden
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

JCFG = JRaster(max_per_tile=64, chunk=32, min_intersections=4096)
TCFG = TRaster(max_per_tile=64, chunk=32)
TOL = dict(atol=1e-5, rtol=1e-4)


def to_torch(st) -> TG.GaussianState:
    return TG.state_from_numpy({k: np.asarray(getattr(st, k))
                                for k in JG.PARAM_FIELDS + ("alive",)}, device="cpu")


def to_jax(st: TG.GaussianState) -> JG.GaussianState:
    return JG.GaussianState(**{k: jnp.asarray(getattr(st, k).numpy())
                               for k in JG.PARAM_FIELDS + ("alive",)})


def cam_to_torch(c) -> TCamera:
    f = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    return TCamera(R_w2c=f(c.R_w2c), t_w2c=f(c.t_w2c), fx=f(c.fx), fy=f(c.fy),
                   cx=f(c.cx), cy=f(c.cy), width=c.width, height=c.height)


def many_view_scene():
    """tests/test_refiner.py:test_refine_cross_view_consistency_many_views's
    scene: 4 objects, 6 views, per-view permuted local SAM ids."""
    rng = np.random.default_rng(7)
    centers = np.array([[-0.7, -0.5, 3.0], [0.7, -0.5, 3.0], [-0.7, 0.5, 3.0],
                        [0.7, 0.5, 3.0]])
    pts = np.concatenate([rng.normal(0, 0.05, (30, 3)) + c for c in centers]).astype(np.float32)
    cols = np.tile([0.5, 0.5, 0.5], (120, 1)).astype(np.float32)
    st = JG.create_from_pcd(pts, cols, capacity=128, seed=0)
    st = dataclasses.replace(st, logit_opacity=jnp.where(
        st.alive, JG.inverse_sigmoid(jnp.float32(0.995)), -10.0))
    obj_of_splat = np.full(128, -1)
    obj_of_splat[:120] = np.repeat(np.arange(4), 30)
    cams = [JCamera.from_fov(np.eye(3), np.asarray([0.04 * v - 0.1, 0.02 * v - 0.05, 0.0]),
                             1.0, 0.8, 64, 48) for v in range(6)]
    sam = np.zeros((6, 48, 64), np.int64)
    perms = [rng.permutation(4) for _ in range(6)]
    for v, cam in enumerate(cams):
        out = jrasterize(cam, st.means, jbuild_cov3d(st.scales, st.quats), st.opacity,
                         jnp.asarray((obj_of_splat[:, None] == np.arange(4)).astype(np.float32)),
                         jnp.zeros(4), JCFG)
        obj = np.asarray(out.image).argmax(-1)
        sam[v] = np.where(np.asarray(out.alpha) > 0.3, perms[v][obj] + 1, 0)
    return st, cams, sam


def two_blob_scene():
    st, cams = test_refiner.two_blob_scene()
    return st, cams, test_refiner.sam_from_silhouettes(st, cams)


SCENES = {"two_blob": two_blob_scene, "golden": test_refiner_golden.scene,
          "many_view": many_view_scene}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    st, cams, sam = SCENES[request.param]()
    return st, cams, sam, to_torch(st), [cam_to_torch(c) for c in cams]


def jax_depth(st, cam):
    out = jrasterize(cam, st.means, jbuild_cov3d(st.scales, st.quats), st.opacity,
                     jnp.zeros((st.capacity, 1)), jnp.zeros(1), JCFG)
    return np.asarray(out.depth / jnp.maximum(out.alpha, 1e-6))


def test_splat_id_votes_matches_jax(scene):
    st, cams, sam, ts, tcams = scene
    M = int(sam.max())
    for v in range(len(cams)):
        depth = jax_depth(st, cams[v])
        jv, jvis = jref.splat_id_votes(st, cams[v], jnp.asarray(sam[v]), jnp.asarray(depth),
                                       M, JCFG)
        tv, tvis = tref.splat_id_votes(ts, tcams[v], torch.as_tensor(sam[v]),
                                       torch.as_tensor(depth), M, TCFG)
        assert float(np.asarray(jv).max()) > 0
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))


def stage2_inputs(st, sam, v: int, seed: int = 0):
    """Seeded stage-2 inputs of view v: global ids, contributions, the synced
    mask and per-id counts."""
    rng = np.random.default_rng(seed)
    M = int(sam.max()) + 2
    gid = np.where(np.asarray(st.alive), rng.integers(0, M + 1, st.capacity), 0).astype(np.int32)
    contrib = rng.random(st.capacity) < 0.7
    synced = np.where(sam[v] > 0, sam[v] + 1, 0).astype(np.int32)
    n_match = rng.integers(0, 5, M).astype(np.float32)
    return M, gid, contrib, synced, n_match


def test_pixel_weight_accumulation_and_expand_match_jax(scene):
    st, cams, sam, ts, tcams = scene
    for v in range(len(cams)):
        M, gid, contrib, synced, n_match = stage2_inputs(st, sam, v, seed=v)
        jargs = (jnp.asarray(gid), jnp.asarray(contrib), jnp.asarray(synced),
                 jnp.asarray(n_match), M, JCFG)
        targs = (torch.as_tensor(gid), torch.as_tensor(contrib), torch.as_tensor(synced),
                 torch.as_tensor(n_match), M, TCFG)
        jw = np.asarray(jref.pixel_weight_accumulation(st, cams[v], *jargs))
        tw = tref.pixel_weight_accumulation(ts, tcams[v], *targs)
        assert tw.shape == jw.shape == (48, 64, M)
        assert (jw[(synced == 0)] > 0).any()  # extension weights are exercised
        np.testing.assert_allclose(tw.numpy(), jw, **TOL)
        je = np.asarray(jref.pixel_weight_expand(st, cams[v], *jargs, 0.5))
        te = tref.pixel_weight_expand(ts, tcams[v], *targs, 0.5)
        np.testing.assert_array_equal(te.numpy(), je)


def test_majority_winner_matches_jax_and_the_insertion_order_dict():
    """test_refiner_golden.py:200's tie-heavy vote matrices."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        V, n, G = rng.integers(2, 9), 200, rng.integers(2, 5)
        dom = rng.integers(0, G + 1, (V, n)).astype(np.int32)
        got = tref.majority_winner(dom)
        np.testing.assert_array_equal(got, jref.majority_winner(dom))
        for s in range(n):
            votes = {}
            for v in range(V):
                if dom[v, s] > 0:
                    votes[int(dom[v, s])] = votes.get(int(dom[v, s]), 0) + 1
            assert got[s] == (max(votes, key=votes.get) if votes else 0)


def test_refine_sam_masks_equals_jax(scene):
    st, cams, sam, ts, tcams = scene
    want = jref.refine_sam_masks(st, cams, sam, JCFG, anchor_stride=1)
    timings = {}
    got = tref.refine_sam_masks(ts, tcams, sam, TCFG, anchor_stride=1, timings=timings)
    assert got.dtype == want.dtype and got.shape == sam.shape
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any() and (got == -1).any()
    assert set(timings) == {"device_votes_s", "host_stage1_merge_s", "host_dominant_s",
                            "host_majority_s", "host_expand_prep_s", "device_expand_s"}


def test_refiner_trace_equals_jax(tmp_path):
    """The traced path (pixel weights to the host, argmax there) gives the
    fused path's masks, and its artifacts are the JAX trace's:
    stage1_sync.npz equal, the same files, summary.json equal."""
    st, cams, sam = test_refiner_golden.scene()
    ts, tcams = to_torch(st), [cam_to_torch(c) for c in cams]
    want = jref.refine_sam_masks(st, cams, sam, JCFG, anchor_stride=1,
                                 trace=JTrace(str(tmp_path / "jax")))
    got = tref.refine_sam_masks(ts, tcams, sam, TCFG, anchor_stride=1,
                                trace=TTrace(str(tmp_path / "torch")))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tref.refine_sam_masks(ts, tcams, sam, TCFG,
                                                             anchor_stride=1))
    jdir, tdir = tmp_path / "jax" / "refine_trace", tmp_path / "torch" / "refine_trace"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    zj, zt = np.load(jdir / "stage1_sync.npz"), np.load(tdir / "stage1_sync.npz")
    assert zt.files == zj.files
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert json.loads((tdir / "summary.json").read_text()) == \
        json.loads((jdir / "summary.json").read_text())


HOOK_OPT = dict(iterations=40, start_ins_feat_iter=10, start_root_cb_iter=100,
                start_leaf_cb_iter=200, densify_from_iter=1000,
                enable_multiview_sam_refinement=True, sam_level=3)


def test_trainer_hook_refines_before_stage_1_like_jax(tmp_path):
    """tests/test_refiner_hook.py's run on the port: the ids are rewritten
    before step start_ins_feat_iter + 1, to what the JAX refiner gives on
    the port's state at that step, and stage 1 goes on with finite losses."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4)
    tr = tloop.Trainer(tdataset.load_scene(root), TConfig(opt=TOpt(**HOOK_OPT)),
                       str(tmp_path / "out"), rcfg=TRaster(max_per_tile=64, chunk=32),
                       device="cpu")
    loaded = tr.bundle.sam_ids.numpy().copy()
    tr.train(until=10, log_every=100)
    before = tr.bundle.sam_ids.numpy().copy()
    np.testing.assert_array_equal(before, loaded)  # not yet: stage 0 ends at 10
    state = to_jax(tr.state)
    cams = [JCamera(**{k: jnp.asarray(getattr(c, k).numpy())
                       for k in ("R_w2c", "t_w2c", "fx", "fy", "cx", "cy")},
                    width=c.width, height=c.height)
            for c in (tr.bundle.camera(i) for i in range(4))]
    tr.train(until=11, log_every=100)
    jcfg = JRaster(max_per_tile=tr.rcfg.max_per_tile, chunk=32, min_intersections=16384)
    want = np.maximum(jref.refine_sam_masks(state, cams, before, jcfg), 0)
    after = tr.bundle.sam_ids.numpy()
    assert after.min() >= 0 and not np.array_equal(before, after)
    np.testing.assert_array_equal(after, want)
    assert tr.bundle.max_masks % 8 == 0 and tr.bundle.max_masks >= max(8, after.max())
    assert os.path.exists(tmp_path / "out" / "refine_trace" / "stage1_sync.npz")
    tr.train(until=20, log_every=100)
    losses = torch.stack(tr.losses).numpy()
    assert len(losses) == 20 and np.isfinite(losses).all()


def test_cli_vis_refinement_writes_its_images(tmp_path):
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    out = str(tmp_path / "vis")
    tcli_vis.main(["-s", root, "--out", out, "--max_cameras", "3", "--max_gaussians", "50"],
                  device="cpu")
    files = sorted(os.listdir(out))
    assert len(files) == 2 * 3 + 1 and "cameras_frustums.png" in files
    assert sum(f.endswith("_before.png") for f in files) == 3
    assert sum(f.endswith("_after.png") for f in files) == 3


def test_cli_train_takes_the_refiner(tmp_path):
    """--enable_multiview_sam_refinement through cli.train: the hook runs and
    writes its trace."""
    from opengaussian_tpu_torch.cli import train as tcli_train

    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    tr = tcli_train.main(["-s", root, "-m", str(tmp_path / "m"), "--iterations", "5",
                          "--start_ins_feat_iter", "3", "--enable_multiview_sam_refinement",
                          "--densify_from_iter", "1000"], device="cpu")
    assert tr.iteration == 5 and tr.cfg.opt.enable_multiview_sam_refinement
    assert os.path.exists(tmp_path / "m" / "refine_trace" / "summary.json")
