"""The mesh trainer: the port's sharded steps of stages 1, 2.1 and 2.2 and
evaluation render, the sharded k-means, sweeps and refiner, and
`cli.train --mesh 2` (Trainer(mesh=...)) on two gloo ranks on the CPU,
against the JAX package's single-device functions and the port's
single-device trainer (tests/test_parallel.py:163-379, 397-470,
tests/test_sweeps_sharded.py, tests/test_refiner_sharded.py).

Every 2-rank scenario runs in one module-scoped spawn of
tests/torch_mesh_stages_worker.py, whose ranks import no JAX: the fixture
writes the scenes (made with the JAX package) to an .npz, the ranks write
their results to .npz files, and the tests compare those. The steps' frame,
80x48, has 15 tiles, so the second rank's band reaches past the grid.
The JAX side blends with its XLA backend, budgets that lose nothing and no
tile windows or frozen plans; the k-means on both sides starts from the same
injected seeds where the values are compared.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.models import optimizer as jopt
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.projection import build_cov3d as jbuild_cov3d
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu.refine import sam_refiner as jref
from opengaussian_tpu.render import render as jrender
from opengaussian_tpu.train import lang as jlang
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu.train import pseudo as jpseudo
from opengaussian_tpu_torch.cli import train as tcli_train
from tests import test_refiner
from tests import torch_mesh_stages_worker as wk
from tests.test_data import make_colmap_scene
from tests.test_torch_rasterize_grad import assert_normalised
from tests.test_torch_train import FIELDS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
W, H = 80, 48
TOL = dict(atol=3e-5, rtol=1e-4)  # the repo's image tolerance
XLA = JRaster(backend="xla", **wk.CFG)
REFINE_CFG = JRaster(max_per_tile=64, chunk=32, min_intersections=4096, backend="xla")


def aligned_scene(cap=384):
    """tests/test_torch_stage22.py:aligned_scene at 80x48: two opaque blobs,
    each a root, under two SAM masks aligned to the rendered silhouette (so
    sweep 2 matches both roots and stage 2.2 has a live root), dead slots and
    feature noise. -> (JAX state, camera, SAM ids)."""
    rng = np.random.default_rng(0)
    n = 300
    pts = np.concatenate([rng.normal(0, 0.08, (150, 3)) + [-0.5, 0, 3.0],
                          rng.normal(0, 0.08, (150, 3)) + [0.5, 0, 3.0]]).astype(np.float32)
    gs = JG.create_from_pcd(pts, rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
                            capacity=cap, seed=0)
    feat = np.zeros((cap, 6), np.float32)
    feat[:150] = [0.9, -0.9, 0.9, -0.9, 0.9, -0.9]
    feat[150:n] = [-0.9, 0.9, -0.9, 0.9, -0.9, 0.9]
    feat[:n] += rng.normal(0, 0.05, (n, 6))
    gs = dataclasses.replace(gs, log_scales=jnp.full_like(gs.log_scales, np.log(0.05)),
                             logit_opacity=jnp.where(gs.alive, 4.0, -10.0),
                             ins_feat=jnp.asarray(feat))
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, W, H)
    sil = np.asarray(jrender(cam, gs, jnp.zeros(3), 3, XLA, render_color=False,
                             render_feat_map=True, origin_feat=True).silhouette)
    sam = np.where(np.arange(W)[None, :] < W // 2, 1, 2)
    return gs, cam, np.where(sil > 0.5, sam, 0).astype(np.int32)


def codebook(gs):
    """The scene's JAX codebook: the roots by assign_root from one seed per
    blob, each root's k2 leaves by assign_leaf from its first members."""
    seeds = np.concatenate([np.asarray(gs.ins_feat), np.asarray(gs.means)], 1)[[0, 150]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkm, "init_centers_from_points", lambda *a: jnp.asarray(seeds))
        kms = jkm.assign_root(jkm.KMeansState.create(gs.capacity, wk.K1, wk.K2),
                              gs.ins_feat, gs.means, gs.alive, 1.0, jax.random.PRNGKey(0),
                              init=True)
        mp.setattr(jkm, "init_centers_from_points",
                   lambda f, w, k, *_: f[jnp.argsort(-w, stable=True)[:k]])
        for r in range(wk.K1):
            kms = jkm.assign_leaf(kms, gs.ins_feat, gs.alive, jnp.int32(r), None, k2=wk.K2,
                                  init=True)
    return kms


def put_state(data, key, gs):
    data.update({f"{key}/state/{k}": np.asarray(getattr(gs, k)) for k in FIELDS + ("alive",)})


def put_camera(data, key, cam):
    for k, v in (("R", cam.R_w2c), ("t", cam.t_w2c), ("fx", cam.fx), ("fy", cam.fy),
                 ("cx", cam.cx), ("cy", cam.cy), ("width", cam.width),
                 ("height", cam.height)):
        data[f"{key}/{k}"] = np.asarray(v)


def bundle(cam, sam, alpha=None):
    """A one-view JAX ViewBundle (alpha: its alpha mask, gated on)."""
    return jloop.ViewBundle(
        R=cam.R_w2c[None], t=cam.t_w2c[None], fx=jnp.asarray([cam.fx]),
        fy=jnp.asarray([cam.fy]), cx=jnp.asarray([cam.cx]), cy=jnp.asarray([cam.cy]),
        gt_images=jnp.zeros((1, H, W, 3)),
        alpha_masks=jnp.ones((1, H, W)) if alpha is None else jnp.asarray(alpha)[None],
        has_alpha=jnp.asarray([alpha is not None]), sam_ids=jnp.asarray(sam)[None],
        width=W, height=H, max_masks=wk.MAX_MASKS)


def refine_inputs():
    st, cams = test_refiner.two_blob_scene()
    sam = test_refiner.sam_from_silhouettes(st, cams)
    rng = np.random.default_rng(3)
    alive = np.asarray(st.alive)
    gid = np.where(alive, rng.integers(1, 3, 128), 0).astype(np.int32)
    contrib = alive & (rng.uniform(size=128) > 0.3)
    n_match = np.bincount(gid[contrib], minlength=3)[1:].astype(np.float32)
    return st, cams, sam, dict(gid=gid, contrib=contrib, synced=sam[0].astype(np.int32),
                               n_match=n_match)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The scenes, as the JAX package makes them, and the .npz the ranks
    read."""
    d = tmp_path_factory.mktemp("mesh_stages")
    gs, cam, sam = aligned_scene()
    gs = fresh(gs)
    kms = codebook(gs)
    pl = jpseudo.construct_pseudo_labels(gs, [cam], jnp.asarray(sam)[None], jnp.zeros(3),
                                         wk.MAX_MASKS, XLA)
    alpha = np.random.default_rng(1).uniform(0.5, 1.0, (H, W)).astype(np.float32)
    data = {"steps/sam": sam, "steps/alpha": alpha, "steps/pseudo": np.asarray(pl.feat[0]),
            "steps/pseudo_ids": np.asarray(pl.mask_ids[0])}
    put_state(data, "steps", gs)
    put_camera(data, "steps/cam", cam)
    data.update({f"steps/kms/{f}": np.asarray(getattr(kms, f)) for f in kms._fields})
    feat, xyz, true = wk.blob_scene()
    cat = np.concatenate([feat, xyz], axis=1)
    data["kmeans/cached"] = np.stack([cat[true == b].mean(0) for b in (2, 0, 1)]).astype(
        np.float32)
    st, cams, rsam, stage2 = refine_inputs()
    put_state(data, "refine", st)
    for v, c in enumerate(cams):
        put_camera(data, f"refine/cam{v}", c)
    data["refine/sam"] = rsam
    data.update({f"refine/{k}": v for k, v in stage2.items()})
    scene = str(d / "scene")
    make_colmap_scene(scene, n_views=4)
    data["scene"] = np.asarray(scene)
    np.savez(d / "inputs.npz", **data)
    return dict(dir=d, gs=gs, cam=cam, sam=sam, kms=kms, pl=pl, alpha=alpha,
                refine=(st, cams, rsam, stage2), scene=scene)


@pytest.fixture(scope="module")
def ranks(scenes):
    """Run tests/torch_mesh_stages_worker.py on two gloo ranks once, and
    meanwhile the port's single-device cli.train run with the same flags ->
    ([rank0, rank1] dicts of arrays, the single-device trainer)."""
    d = scenes["dir"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("OPENGS_")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_stages_worker.py"), str(r),
         str(WORLD), str(d / "store"), str(d / "inputs.npz"), str(d)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        single = tcli_train.main(["-s", scenes["scene"], "-m", str(d / "cli_single"),
                                  *wk.SCHEDULE], device="cpu")
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)], single


def joined(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def fresh(gs):
    return JG.GaussianState(**{k: jnp.array(np.asarray(getattr(gs, k)))
                               for k in FIELDS + ("alive",)})


def jax_step(scenes, name):
    """The JAX package's single-device step `name` on the scene's fresh state.
    -> (state, adam, loss, ok or None, n_lost)."""
    cam, sam, kms, pl = (scenes[k] for k in ("cam", "sam", "kms", "pl"))
    gs = fresh(scenes["gs"])  # the JAX steps donate their state
    adam = jopt.init(gs.params())
    it, rescale = jnp.int32(wk.STEP_ITS[name[:7]]), jnp.float32(wk.RESCALE[name[:7]])
    if name == "stage1":
        s, a, loss, lost = jloop.stage1_step(gs, adam, bundle(cam, sam, scenes["alpha"]),
                                             jnp.int32(0), it, jnp.zeros(3), rescale, XLA,
                                             JOpt(), True)
        return s, a, loss, None, lost
    if name == "stage21":
        s, a, loss, lost = jloop.stage21_step(gs, adam, kms, bundle(cam, sam), jnp.int32(0),
                                              it, jnp.zeros(3), rescale, pl.feat[0], XLA,
                                              JOpt())
        return s, a, loss, None, lost
    return jloop.stage22_step(gs, adam, kms, bundle(cam, sam), jnp.int32(0), it,
                              jnp.zeros(3), rescale, pl.feat[0], jnp.int32(0),
                              jnp.bool_(name == "stage22_live"), XLA, JOpt())


STEP_CASES = [("stream", "stage1"), ("dense", "stage1"), ("compact", "stage1"),
              ("stream", "stage21"), ("stream", "stage22_live"), ("stream", "stage22_dead"),
              ("compact", "stage22_live")]


@pytest.mark.parametrize("layout,name", STEP_CASES)
def test_sharded_stage_matches_jax(ranks, scenes, layout, name):
    """tests/test_parallel.py:163-246, 397-460: one sharded step (stage 1
    with the alpha term gated on) gives the JAX single-device step's loss,
    and, the ranks' shards put together, its ins_feat and Adam moments
    (1e-3 normalised); the geometry stays frozen; ok and n_lost are equal
    on both ranks, ok the JAX step's (stage 2.2 on a root that occurs, and
    on one sweep 2 hid), nothing lost."""
    ranks, _single = ranks
    j_state, j_adam, j_loss, j_ok, j_lost = jax_step(scenes, name)
    key = f"steps/{layout}/{name}"
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{key}/loss"]), float(j_loss), rtol=1e-4,
                                   atol=1e-7)
        assert int(r[f"{key}/n_lost"]) == int(j_lost) == 0
        assert bool(r[f"{key}/means_same"])
        if j_ok is not None:
            assert bool(r[f"{key}/ok"]) == bool(j_ok) == (name == "stage22_live")
    assert_normalised(joined(ranks, f"{key}/ins_feat"), np.asarray(j_state.ins_feat), 1e-3,
                      "ins_feat")
    if name != "stage22_dead":
        assert float(j_loss) > 0
        for m, want in (("mu", j_adam.mu), ("nu", j_adam.nu)):
            assert_normalised(joined(ranks, f"{key}/{m}"), np.asarray(want["ins_feat"]), 1e-3,
                              m)
    else:  # a hidden root: no loss and no gradient, but Adam steps
        assert float(j_loss) == 0.0
        assert not joined(ranks, f"{key}/mu").any()


def test_sharded_eval_render_matches_jax(ranks, scenes):
    """eval_render: the JAX single-device color pass on every rank."""
    ranks, _single = ranks
    out = jrender(scenes["cam"], scenes["gs"], jnp.zeros(3), 3, XLA)
    for r in ranks:
        np.testing.assert_allclose(r["steps/eval/image"], np.asarray(out.render), **TOL)
        np.testing.assert_allclose(r["steps/eval/alpha"], np.asarray(out.alpha), **TOL)
        np.testing.assert_allclose(r["steps/eval/depth"], np.asarray(out.depth), atol=3e-4)


def _jax_root(init: bool, cached=None):
    feat, xyz, _ = wk.blob_scene()
    n = len(feat)
    st = jkm.KMeansState.create(n, 3, 2)
    if cached is not None:
        st = st._replace(centers=jnp.asarray(cached))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkm, "init_centers_from_points",
                   lambda *a: jnp.asarray(wk.root_seeds(feat, xyz)))
        return jkm.assign_root(st, jnp.asarray(feat), jnp.asarray(xyz),
                               jnp.ones(n, bool), 1.0, jax.random.PRNGKey(0), init=init)


@pytest.mark.parametrize("name", ["seeded", "reassign"])
def test_sharded_root_kmeans_matches_jax(ranks, scenes, name):
    """assign_root_sharded from the same seeds as the JAX single-device
    assign_root (for the reassignment, its restart's seeds, against cached
    centers): the same centers on both ranks, within 1e-5 of JAX's, and the
    same assignment."""
    ranks, _single = ranks
    want = _jax_root(name == "seeded", None if name == "seeded" else
                     np.load(scenes["dir"] / "inputs.npz")["kmeans/cached"])
    key = f"kmeans/root/{name}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/centers"], np.asarray(want.centers), atol=1e-5)
    np.testing.assert_array_equal(joined(ranks, f"{key}/ids"), np.asarray(want.cls_ids))


def test_sharded_root_kmeans_pool_quality_and_alignment(ranks):
    """tests/test_parallel.py:292-339: from the pool's k-means++ each blob
    goes to one root of its own (90% of its rows at least); a reassignment
    from good cached centers keeps their labels and converges to the blob
    means."""
    ranks, _single = ranks
    feat, xyz, true = wk.blob_scene()
    per = len(feat) // 3
    ids = joined(ranks, "kmeans/root/pool/ids")
    used = set()
    for b in range(3):
        h = np.bincount(ids[true == b], minlength=3)
        assert h.max() >= int(per * 0.9), h
        used.add(int(h.argmax()))
    assert len(used) == 3
    ids = joined(ranks, "kmeans/root/pool_reassign/ids")
    for b, lab in {2: 0, 0: 1, 1: 2}.items():
        h = np.bincount(ids[true == b], minlength=3)
        assert int(h.argmax()) == lab and h[lab] >= int(per * 0.9), (b, h)
    cat = np.concatenate([feat, xyz], axis=1)
    cached = np.stack([cat[true == b].mean(0) for b in (2, 0, 1)])
    for r in ranks:
        np.testing.assert_allclose(r["kmeans/root/pool_reassign/centers"], cached, atol=0.05)


def test_sharded_leaf_kmeans_matches_jax(ranks):
    """assign_leaf_sharded from the JAX single-device assign_leaf's seeds:
    its centers and assignment; from the pool (tests/test_parallel.py:
    342-379): root 1 untouched, root 0's sub-blobs split into exactly its 2
    active slots."""
    ranks, _single = ranks
    feat, cls = wk.leaf_scene()
    n = len(feat)
    st = jkm.KMeansState.create(n, 2, 4)._replace(
        cls_ids=jnp.asarray(cls), leaf_sub_num=jnp.asarray([2, 1], jnp.int32))
    seeds = feat[[0, n // 4 + 1, 2, 3]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jkm, "init_centers_from_points", lambda *a: jnp.asarray(seeds))
        want = jkm.assign_leaf(st, jnp.asarray(feat), jnp.ones(n, bool), jnp.int32(0),
                               jax.random.PRNGKey(2), k2=4, init=True)
    for r in ranks:
        np.testing.assert_allclose(r["kmeans/leaf/seeded/centers"], np.asarray(want.leaf_centers),
                                   atol=1e-5)
    np.testing.assert_array_equal(joined(ranks, "kmeans/leaf/seeded/ids"),
                                  np.asarray(want.leaf_cls_ids))
    ids = joined(ranks, "kmeans/leaf/pool/ids")
    assert (ids[n // 2:] == 2 * 4).all()
    a, b = ids[: n // 4], ids[n // 4: n // 2]
    assert set(np.unique(a)) | set(np.unique(b)) <= {0, 1}
    assert np.unique(a).size == 1 and np.unique(b).size == 1 and a[0] != b[0]


def test_sharded_sweeps_match_jax(ranks, scenes):
    """tests/test_sweeps_sharded.py: sweep 1, sweep 2 and the stage-3
    association of the view, and the leaf-mode pseudo labels through the
    sharded sweeps, equal the JAX single-device ones on every rank (features
    to 3e-5, scores to 1e-4); both roots match."""
    ranks, _single = ranks
    gs, cam, sam, kms, pl = (scenes[k] for k in ("gs", "cam", "sam", "kms", "pl"))
    bg = jnp.zeros(3)
    f1, m1 = jpseudo._sweep1_view(gs, cam, jnp.asarray(sam), bg, wk.MAX_MASKS, XLA)
    c2, o2 = jpseudo._sweep2_view(gs, cam, pl.feat[0], pl.mask_ids[0], kms.cls_ids, bg,
                                  wk.MAX_MASKS, wk.K1, XLA)
    mid, sc, ok = jlang._associate_view(gs, kms.leaf_cls_ids, cam, pl.feat[0], pl.mask_ids[0],
                                        jnp.ones(wk.K1, bool), bg, wk.K1, wk.K2,
                                        wk.MAX_MASKS, XLA)
    leaf = jpseudo.construct_pseudo_labels(gs, [cam], jnp.asarray(sam)[None], bg,
                                           wk.MAX_MASKS, XLA, mode="leaf",
                                           cls_ids=kms.cls_ids, k1=wk.K1, k2=wk.K2)
    assert np.asarray(o2).all() and np.asarray(ok).any()
    for r in ranks:
        np.testing.assert_allclose(r["sweeps/sweep1/feat"], np.asarray(f1), atol=3e-5)
        np.testing.assert_array_equal(r["sweeps/sweep1/ids"], np.asarray(m1))
        np.testing.assert_array_equal(r["sweeps/sweep2/counts"], np.asarray(c2))
        np.testing.assert_array_equal(r["sweeps/sweep2/occur"], np.asarray(o2))
        np.testing.assert_array_equal(r["sweeps/lang/ok"], np.asarray(ok))
        np.testing.assert_array_equal(r["sweeps/lang/mid"], np.asarray(mid))
        np.testing.assert_allclose(r["sweeps/lang/score"], np.asarray(sc), atol=1e-4)
        np.testing.assert_allclose(r["sweeps/pseudo/feat"], np.asarray(leaf.feat), atol=3e-5)
        for f in ("mask_ids", "cluster_occur", "leaf_sub_num"):
            np.testing.assert_array_equal(r[f"sweeps/pseudo/{f}"], np.asarray(getattr(leaf, f)))


def test_truncating_sharded_sweep2_matches_jax(ranks, scenes):
    """Sweep 2 at a max_per_tile below the union binning's deepest tile:
    the port's sharded sweep 2 on two ranks loses the same slots and gives
    the same counts and occurrences as the JAX package's sharded sweep 2
    (parallel/sweeps.py:make_sweep_fns) on two of its virtual CPU devices."""
    from opengaussian_tpu.parallel import sweeps as jsweeps
    from opengaussian_tpu.parallel.mesh import make_mesh, shard_gaussians
    from opengaussian_tpu.render import COARSE_SCALE_LIMIT, encoded_ins_feat

    ranks, _single = ranks
    gs, cam, kms, pl = (scenes[k] for k in ("gs", "cam", "kms", "pl"))
    bg = jnp.zeros(3)
    cfg = JRaster(backend="xla", **dict(wk.CFG, max_per_tile=wk.TRUNC_K))
    mesh = make_mesh(WORLD)
    gs_sh, cls_sh = shard_gaussians(mesh, (gs, kms.cls_ids))
    c2, o2 = jsweeps.make_sweep_fns(mesh, cfg, wk.K1, wk.K2, wk.MAX_MASKS).sweep2(
        gs_sh, cam, pl.feat[0], pl.mask_ids[0], cls_sh, bg)
    opac_g, _ = jsweeps._cluster_opacities(gs_sh, cls_sh, jnp.arange(wk.K1), True,
                                           COARSE_SCALE_LIMIT)
    *_, lost = jsweeps.render_groups_sharded(
        mesh, cam, gs_sh.means, jbuild_cov3d(gs_sh.scales, gs_sh.quats), opac_g,
        encoded_ins_feat(gs_sh, None, origin_feat=True), jnp.concatenate([bg, bg]), cfg)
    assert int(lost) > 0  # the union binning truncates at this cap
    for r in ranks:
        assert int(r["sweeps/trunc/n_lost"]) == int(lost)
        np.testing.assert_array_equal(r["sweeps/trunc/counts"], np.asarray(c2))
        np.testing.assert_array_equal(r["sweeps/trunc/occur"], np.asarray(o2))


def test_lang_view_gathers_independent_of_k1(ranks):
    """tests/test_sweeps_sharded.py:213: one view of the sharded association
    all-gathers the same tensors whatever k1 (the projected table and the
    per-splat vectors once per view, never once per root)."""
    ranks, _single = ranks
    for r in ranks:
        a, b = r["sweeps/gathers/k1_2"], r["sweeps/gathers/k1_4"]
        np.testing.assert_array_equal(a, b)
        assert 0 < len(a) <= 5, a


def test_sharded_refiner_matches_jax(ranks, scenes):
    """tests/test_refiner_sharded.py: each view's depth, votes and
    visibility, the stage-2 weights, and the refined ids through the sharded
    passes equal the JAX single-device refiner's at the same config; the
    trace is written once, by rank 0."""
    ranks, _single = ranks
    st, cams, sam, s2 = scenes["refine"]
    for v in range(2):
        out = jrasterize(cams[v], st.means, jbuild_cov3d(st.scales, st.quats), st.opacity,
                         jnp.zeros((st.capacity, 1)), jnp.zeros(1), REFINE_CFG)
        depth = out.depth / jnp.maximum(out.alpha, 1e-6)
        votes, vis = jref.splat_id_votes(st, cams[v], jnp.asarray(sam[v]), depth, 2, REFINE_CFG)
        for r in ranks:
            np.testing.assert_allclose(r[f"refine/depth{v}"], np.asarray(depth), atol=1e-4)
            np.testing.assert_array_equal(r[f"refine/visible{v}"], np.asarray(vis))
            np.testing.assert_allclose(r[f"refine/votes{v}"], np.asarray(votes), atol=1e-4)
    w = jref.pixel_weight_accumulation(st, cams[0], jnp.asarray(s2["gid"]),
                                       jnp.asarray(s2["contrib"]), jnp.asarray(s2["synced"]),
                                       jnp.asarray(s2["n_match"]), 2, REFINE_CFG)
    ids = jref.refine_sam_masks(st, cams, sam, REFINE_CFG, anchor_stride=1)
    for r in ranks:
        np.testing.assert_allclose(r["refine/weights"], np.asarray(w), atol=1e-4)
        np.testing.assert_array_equal(r["refine/ids"], ids)
    trace = scenes["dir"] / "refine" / "refine_trace"
    assert (trace / "stage1_sync.npz").exists() and (trace / "refined_1.png").exists()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _s, fs in os.walk(root)
                  for f in fs if not f.startswith("events.out.tfevents"))


def test_mesh_trainer_matches_single_device(ranks, scenes):
    """cli.train --mesh 2 (Trainer(mesh=...)) through every stage, the
    refiner, stage 3 and a checkpoint: the first step of each stage within
    1e-3 of the port's single-device run with the same seed, the same alive
    counts at every record (the densify events alike), the same refined SAM
    ids, the same capacity; the same losses and evaluation on both ranks;
    the checkpoint restores into a second mesh trainer bit for bit."""
    ranks, single = ranks
    want = torch.stack(single.losses).numpy()
    o = single.cfg.opt
    firsts = [0, o.start_ins_feat_iter, o.start_root_cb_iter, o.start_leaf_cb_iter]
    for r in ranks:
        got = r["trainer/losses"]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got[firsts], want[firsts], rtol=1e-3, atol=1e-6)
        np.testing.assert_array_equal(r["trainer/alive"], [h["num_alive"] for h in single.history])
        np.testing.assert_array_equal(r["trainer/its"], [h["iteration"] for h in single.history])
        np.testing.assert_array_equal(r["trainer/sam_ids"], single.bundle.sam_ids.numpy())
        assert int(r["trainer/capacity"]) * WORLD == single.state.capacity
        assert bool(r["trainer/restored_equal"])
        assert "a mesh of 3 devices in a world of 2" in str(r["trainer/mesh3"])
    for k in ("trainer/losses", "trainer/psnr", "trainer/ins_feat", "trainer/cls_ids"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    assert abs(float(ranks[0]["trainer/psnr"]) - single.evaluate()["psnr"]) < 0.05


def test_cli_mesh_writes_the_single_device_files(ranks, scenes):
    """cli.train --mesh 2 writes the files --mesh 0 writes (rank 0 alone:
    one cluster_lang.npz, one checkpoint, the PLYs and codebooks), with the
    same configuration, the same per-splat codebook ids and leaf ids in
    cluster_lang.npz, and the dump of the mesh trainer's view."""
    ranks, _single = ranks
    d = scenes["dir"]
    mesh_files, single_files = _files(d / "cli_mesh"), _files(d / "cli_single")
    strip = lambda fs: [f for f in fs if not f.startswith("train_process")]  # noqa: E731
    assert strip(mesh_files) == strip(single_files)
    assert "train_process/stage2_2/ins_feat/00016.png" in mesh_files
    assert {"cluster_lang.npz", "chkpnt16.npz", "cfg_args.json"} <= set(mesh_files)
    with open(d / "cli_mesh" / "cfg_args.json") as a, open(d / "cli_single" / "cfg_args.json") as b:
        assert a.read().replace("cli_mesh", "cli_single") == b.read()
    zm, zs = np.load(d / "cli_mesh" / "cluster_lang.npz"), np.load(d / "cli_single" /
                                                                   "cluster_lang.npz")
    assert sorted(zm.files) == sorted(zs.files)
    np.testing.assert_array_equal(zm["leaf_ind"], zs["leaf_ind"])
    for f in zm.files:
        assert zm[f].shape == zs[f].shape and np.isfinite(zm[f]).all(), f
