"""The port's stage 2.2 and stage 3 against the JAX package's: the mask
helpers, `assign_leaf`, sweep 2 and the leaf-mode pseudo labels, one
`stage22_step` in each input layout and with the compact backward, the
language association and its `cluster_lang.npz`, and a `cli.train` run
through every stage.

The JAX side runs its XLA blend (backend="xla"), which the repo's own tests
hold against its Pallas kernels; the port runs its kernels' plain versions.

Traps to rule out before filing a mismatch as a fault:
  * RNG: the k-means++ seeds come from each package's own generator; the
    tests hand both the same seeds.
  * Stage 2.x trajectories: the silhouette gates and the k-means argmin fork
    long runs on tiny differences, so the trainer run compares regimes past
    its first stage-2.1 step.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.models import optimizer as jopt
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.render import render as jrender
from opengaussian_tpu.train import lang as jlang
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu.train import pseudo as jpseudo
from opengaussian_tpu.utils import masks as jmasks
from opengaussian_tpu_torch.cameras import Camera as TCamera
from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import lang as tlang
from opengaussian_tpu_torch.train import loop as tloop
from opengaussian_tpu_torch.train import pseudo as tpseudo
from opengaussian_tpu_torch.utils import codebook
from opengaussian_tpu_torch.utils import masks as tmasks
from tests.test_data import make_colmap_scene
from tests.test_torch_train import FIELDS, normalised_close

torch.set_num_threads(1)

W, H = 64, 48
K1, K2 = 2, 3
XLA = JRaster(max_per_tile=256, chunk=32, min_intersections=16384, backend="xla")
TOL = dict(atol=3e-5, rtol=1e-4)
GEOMETRY = tuple(k for k in FIELDS if k != "ins_feat")
LAYOUTS = {"stream": dict(), "dense": dict(pallas_input="dense"),
           "compact": dict(bwd_layout="compact")}


def tcfg(layout="stream"):
    return TRaster(max_per_tile=256, chunk=32, **LAYOUTS[layout])


def aligned_scene(cap=384):
    """tests/test_pseudo_sweep2.py:aligned_scene at 64x48, with dead slots
    and feature noise: two opaque blobs, each one root cluster, under two
    SAM masks that the rendered silhouette aligns, so sweep 2 matches every
    root. -> (JAX state, port state, root ids [cap], JAX camera, SAM ids)."""
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
    sam = np.where(sil > 0.5, sam, 0).astype(np.int32)
    roots = np.zeros(cap, np.int32)
    roots[150:n] = 1
    t_gs = TG.state_from_numpy({k: np.asarray(getattr(gs, k)) for k in FIELDS + ("alive",)},
                               device="cpu")
    return gs, t_gs, roots, cam, sam


def tcam(cam):
    return TCamera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, W, H)


def bundles(cam, sam):
    common = dict(width=W, height=H, max_masks=8)
    jb = jloop.ViewBundle(
        R=cam.R_w2c[None], t=cam.t_w2c[None], fx=jnp.asarray([cam.fx]),
        fy=jnp.asarray([cam.fy]), cx=jnp.asarray([cam.cx]), cy=jnp.asarray([cam.cy]),
        gt_images=jnp.zeros((1, H, W, 3)), alpha_masks=jnp.ones((1, H, W)),
        has_alpha=jnp.asarray([False]), sam_ids=jnp.asarray(sam)[None], **common)
    tb = tloop.ViewBundle(
        R=torch.tensor(np.asarray(cam.R_w2c))[None],
        t=torch.tensor(np.asarray(cam.t_w2c))[None], fx=torch.tensor([float(cam.fx)]),
        fy=torch.tensor([float(cam.fy)]), cx=torch.tensor([float(cam.cx)]),
        cy=torch.tensor([float(cam.cy)]), gt_images=torch.zeros((1, H, W, 3)),
        alpha_masks=torch.ones((1, H, W)), has_alpha=torch.tensor([False]),
        sam_ids=torch.tensor(sam)[None], **common)
    return jb, tb


def port_kms(kms):
    return tkm.kmeans_from_numpy({f: np.asarray(getattr(kms, f)) for f in kms._fields},
                                 device="cpu")


def leaf_codebook(gs, roots, sub_num, monkeypatch):
    """JAX KMeansState with the given roots and each root's leaves assigned
    by assign_leaf from deterministic seeds."""
    monkeypatch.setattr(jkm, "init_centers_from_points", lambda feat, w, k, *_: feat[:k])
    kms = jkm.KMeansState.create(gs.capacity, K1, K2)._replace(
        cls_ids=jnp.asarray(roots), leaf_sub_num=jnp.asarray(sub_num, jnp.int32))
    for r in range(K1):
        kms = jkm.assign_leaf(kms, gs.ins_feat, gs.alive, jnp.int32(r), None, k2=K2,
                              init=True)
    return kms


def test_clip_feat_slice_and_pair_mean_match_jax():
    rng = np.random.default_rng(0)
    packed = np.stack([rng.integers(-1, 4 + 3 * lv, (H, W)) for lv in range(4)]).astype(np.int16)
    for level in range(4):
        assert tmasks.clip_feat_slice(packed, level) == jmasks.clip_feat_slice(packed, level)
    feat = rng.uniform(size=(5, H, W, 6)).astype(np.float32)
    masks = rng.uniform(size=(5, H, W)) < 0.3
    masks[4] = False  # an empty mask: the mean is 0
    got = tmasks.pair_mask_feature_mean(torch.as_tensor(feat), torch.as_tensor(masks))
    want = jmasks.pair_mask_feature_mean(jnp.asarray(feat), jnp.asarray(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[4].any()


@pytest.mark.parametrize("init", [True, False])
def test_assign_leaf_matches_jax(init, monkeypatch):
    """One root's leaves from injected seeds (init) or from its cached leaf
    centers, with a leaf_sub_num below k2 masking the last slot."""
    rng = np.random.default_rng(1)
    cap, k1, k2 = 256, 4, 3
    feat = rng.normal(0, 1, (cap, 6)).astype(np.float32)
    alive = rng.uniform(size=cap) < 0.9
    roots = rng.integers(0, k1, cap).astype(np.int32)
    centers = rng.normal(0, 1, (k1 * k2 + 1, 6)).astype(np.float32)
    kms = jkm.KMeansState.create(cap, k1, k2)._replace(
        cls_ids=jnp.asarray(roots), leaf_centers=jnp.asarray(centers),
        leaf_sub_num=jnp.asarray([3, 2, 3, 1], jnp.int32))
    seeds = feat[(roots == 1) & alive][:k2]
    weights = []

    def stub(f, w, k, *_):
        weights.append(np.asarray(w))
        return jnp.asarray(seeds)

    monkeypatch.setattr(jkm, "init_centers_from_points", stub)
    want = jkm.assign_leaf(kms, jnp.asarray(feat), jnp.asarray(alive), jnp.int32(1),
                           jax.random.PRNGKey(0), k2=k2, init=init)
    got = tkm.assign_leaf(port_kms(kms), torch.as_tensor(feat), torch.as_tensor(alive), 1, k2,
                          init=init, init_centers=torch.as_tensor(seeds))
    np.testing.assert_allclose(got.leaf_centers.numpy(), np.asarray(want.leaf_centers),
                               atol=1e-5)
    np.testing.assert_array_equal(got.leaf_cls_ids.numpy(), np.asarray(want.leaf_cls_ids))
    member = (roots == 1) & alive
    ids = got.leaf_cls_ids.numpy()
    assert set(ids[member]) == {3, 4}  # slot 5 is past leaf_sub_num = 2
    assert (ids[~member] == k1 * k2).all()
    if init:  # the JAX draw weighs non-members at 1e-9
        assert weights and weights[0].min() == pytest.approx(1e-9)
    else:  # the masked slot keeps its cached center
        np.testing.assert_array_equal(got.leaf_centers.numpy()[5], centers[5])


def test_sweep2_math_matches_jax():
    """Clusters over four quadrant masks: matched, mismatched by feature,
    too small, not occurring."""
    rng = np.random.default_rng(2)
    ids = (1 + np.arange(W)[None, :] // 32 + 2 * (np.arange(H)[:, None] // 24)).astype(np.int32)
    ids = np.where(rng.uniform(size=(H, W)) < 0.05, 0, ids)
    pfeat = rng.uniform(0.3, 0.7, (4, 6)).astype(np.float32)[np.clip(ids - 1, 0, 3)]
    k1 = 5
    imgs = np.repeat(pfeat[None], k1, 0) + rng.normal(0, 0.01, (k1, H, W, 6)).astype(np.float32)
    imgs[1] += 0.5  # far in feature space
    sils = np.stack([(ids == q + 1) * 0.95 for q in (0, 1, 2, 3)] + [np.zeros((H, W))])
    sils[3, :, :5] = 0.95  # spills over a second mask
    sils = sils.astype(np.float32)
    occur = np.array([True, True, True, False, True])
    want = jpseudo.sweep2_math(*map(jnp.asarray, (imgs, sils, occur, pfeat, ids)), 8)
    got = tpseudo.sweep2_math(*map(torch.as_tensor, (imgs, sils, occur, pfeat, ids)), 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].numpy().tolist() == [True, False, True, False, False]


@pytest.mark.parametrize("layout", ["stream", "dense"])
def test_leaf_pseudo_labels_match_jax(layout):
    """Sweep 2 (_sweep2_view) and leaf-mode construct_pseudo_labels: every
    root matches its mask, so leaf_sub_num is 1 + 1."""
    gs, t_gs, roots, cam, sam = aligned_scene()
    want = jpseudo.construct_pseudo_labels(gs, [cam], jnp.asarray(sam)[None], jnp.zeros(3), 8,
                                           XLA, mode="leaf", cls_ids=jnp.asarray(roots),
                                           k1=K1, k2=K2)
    got = tpseudo.construct_pseudo_labels(t_gs, [tcam(cam)], torch.as_tensor(sam)[None],
                                          torch.zeros(3), 8, tcfg(layout), mode="leaf",
                                          cls_ids=torch.as_tensor(roots), k1=K1, k2=K2)
    np.testing.assert_allclose(got.feat.numpy(), np.asarray(want.feat), **TOL)
    np.testing.assert_array_equal(got.mask_ids.numpy(), np.asarray(want.mask_ids))
    np.testing.assert_array_equal(got.cluster_occur.numpy(), np.asarray(want.cluster_occur))
    np.testing.assert_array_equal(got.leaf_sub_num.numpy(), np.asarray(want.leaf_sub_num))
    assert got.cluster_occur.numpy().all() and got.leaf_sub_num.tolist() == [2, 2]
    c, o = tpseudo._sweep2_view(t_gs, tcam(cam), got.feat[0], got.mask_ids[0],
                                torch.as_tensor(roots), torch.zeros(3), 8, K1, tcfg(layout))
    jc, jo = jpseudo._sweep2_view(gs, cam, want.feat[0], want.mask_ids[0], jnp.asarray(roots),
                                  jnp.zeros(3), 8, K1, XLA)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("layout,visible", [("stream", True), ("dense", True),
                                            ("compact", True), ("stream", False)])
def test_stage22_step_matches_jax(layout, visible, monkeypatch):
    """From the same state, leaf codebook, pseudo features and Adam moments:
    the loss, ins_feat, its moments, and the geometry unchanged. A root the
    view does not see gets no gradient, but Adam still steps."""
    gs, t_gs, roots, cam, sam = aligned_scene()
    jb, tb = bundles(cam, sam)
    kms = leaf_codebook(gs, roots, [2, 2], monkeypatch)
    pl = jpseudo.construct_pseudo_labels(gs, [cam], jb.sam_ids, jnp.zeros(3), 8, XLA)
    rng = np.random.default_rng(3)
    adam = jopt.init(gs.params())
    adam = adam._replace(
        mu={**adam.mu, "ins_feat": jnp.asarray(rng.normal(0, 1e-3, gs.ins_feat.shape),
                                               jnp.float32)},
        nu={**adam.nu, "ins_feat": jnp.asarray(rng.uniform(0, 1e-6, gs.ins_feat.shape),
                                               jnp.float32)},
        count=jnp.int32(3))
    t_adam = TG.adam_from_numpy({k: np.asarray(v) for k, v in adam.mu.items()},
                                {k: np.asarray(v) for k, v in adam.nu.items()}, 3, device="cpu")
    it, rescale, root = 50_001, 0.8, 1
    j_state, j_adam, j_loss, j_ok, j_lost = jloop.stage22_step(
        gs, adam, kms, jb, jnp.int32(0), jnp.int32(it), jnp.zeros(3), jnp.float32(rescale),
        pl.feat[0], jnp.int32(root), jnp.bool_(visible), XLA, JOpt())
    t_new, t_adam2, loss, ok, lost = tloop.stage22_step(
        t_gs, t_adam, port_kms(kms), tb, 0, it, torch.zeros(3), rescale,
        torch.tensor(np.asarray(pl.feat[0])), root, visible, tcfg(layout), TOpt())
    assert bool(ok) == bool(j_ok) == visible and int(lost) == int(j_lost) == 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    for k in FIELDS:
        normalised_close(getattr(t_new, k), getattr(j_state, k), 1e-3, f"param {k}")
        normalised_close(t_adam2.mu[k], j_adam.mu[k], 1e-3, f"mu {k}")
        normalised_close(t_adam2.nu[k], j_adam.nu[k], 1e-3, f"nu {k}")
    for k in GEOMETRY:
        assert torch.equal(getattr(t_new, k), getattr(t_gs, k)), k
    assert t_adam2.count == int(j_adam.count) == 4
    if visible:
        assert float(j_loss) > 0
    else:  # zero gradient: the moments only decay
        assert float(loss) == 0.0
        torch.testing.assert_close(t_adam2.mu["ins_feat"], 0.9 * t_adam.mu["ins_feat"])


def test_score_leaves_matches_jax():
    rng = np.random.default_rng(4)
    ids = (1 + np.arange(W)[None, :] // 32 + 2 * (np.arange(H)[:, None] // 24)).astype(np.int32)
    pm, pm_valid = jmasks.masks_onehot(jnp.asarray(ids), 8)
    feat = rng.uniform(size=(H, W, 6)).astype(np.float32)
    p_mean = jmasks.mask_feature_mean(jnp.asarray(feat), pm)
    imgs = np.repeat(feat[None], 3, 0) + rng.normal(0, 0.02, (3, H, W, 6)).astype(np.float32)
    sils = np.stack([(ids == 1) * 0.9, (ids <= 2) * 0.9, np.zeros((H, W))]).astype(np.float32)
    valid = np.array([True, True, False])
    for vis in (True, False):
        want = jlang.score_leaves(jnp.asarray(imgs), jnp.asarray(sils), jnp.asarray(valid),
                                  pm, pm_valid, p_mean, jnp.bool_(vis))
        got = tlang.score_leaves(*map(torch.tensor, (imgs, sils, valid, np.asarray(pm),
                                                     np.asarray(pm_valid),
                                                     np.asarray(p_mean))),
                                 torch.tensor(vis))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert got[2].numpy().tolist() == [vis, vis, False]


@pytest.mark.parametrize("layout", ["stream", "dense"])
def test_associate_language_matches_jax(layout, tmp_path, monkeypatch):
    """_associate_view and associate_language over two views (the second
    without a CLIP table): the matches and the saved cluster_lang.npz. The
    port's stream layout renders each root's leaves in one partition, the
    JAX package's XLA path one leaf after the other."""
    gs, t_gs, roots, cam, sam = aligned_scene()
    kms = leaf_codebook(gs, roots, [2, 2], monkeypatch)
    jb, tb = bundles(cam, sam)
    jb = jax.tree.map(lambda x: jnp.concatenate([x, x]), jb)
    tb = dataclasses.replace(tb, **{f.name: torch.cat([getattr(tb, f.name)] * 2)
                                    for f in dataclasses.fields(tb)
                                    if isinstance(getattr(tb, f.name), torch.Tensor)})
    pl = jpseudo.construct_pseudo_labels(gs, [cam, cam], jb.sam_ids, jnp.zeros(3), 8, XLA,
                                         mode="leaf", cls_ids=kms.cls_ids, k1=K1, k2=K2)
    t_pl = tpseudo.pseudo_from_numpy(np.asarray(pl.feat), np.asarray(pl.mask_ids), "cpu",
                                     np.asarray(pl.cluster_occur), np.asarray(pl.leaf_sub_num))
    tables = [np.random.default_rng(5).uniform(size=(3, 512)).astype(np.float32), None]
    t_kms = port_kms(kms)
    want_v = jlang._associate_view(gs, kms.leaf_cls_ids, cam, pl.feat[0], pl.mask_ids[0],
                                   pl.cluster_occur[0], jnp.zeros(3), K1, K2, 8, XLA)
    got_v = tlang._associate_view(t_gs, t_kms.leaf_cls_ids, tcam(cam), t_pl.feat[0],
                                  t_pl.mask_ids[0], t_pl.cluster_occur[0], torch.zeros(3),
                                  K1, K2, 8, tcfg(layout))
    np.testing.assert_array_equal(got_v[0].numpy(), np.asarray(want_v[0]))
    np.testing.assert_allclose(got_v[1].numpy(), np.asarray(want_v[1]), **TOL)
    np.testing.assert_array_equal(got_v[2].numpy(), np.asarray(want_v[2]))
    assert got_v[2].numpy().any()  # some leaf matched: the fixture exercises the gates
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jlang.associate_language(gs, kms, jb, pl, tables, jnp.zeros(3), K1, K2, XLA, jpath)
    got = tlang.associate_language(t_gs, t_kms, tb, t_pl, tables, torch.zeros(3), K1, K2,
                                   tcfg(layout), tpath)
    want, saved = np.load(jpath), np.load(tpath)
    assert sorted(saved.files) == sorted(want.files) == sorted(got)
    assert saved["leaf_feat"].shape == (K1 * K2, 512)
    assert saved["leaf_ind"].shape == (int(np.asarray(gs.alive).sum()),)
    for k in want.files:
        np.testing.assert_allclose(saved[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(saved[k], got[k])


def test_cli_train_through_stage3_matches_jax(tmp_path, monkeypatch):
    """cli.train over 0 -> 1 -> 2.1 -> 2.2 -> stage 3 on make_colmap_scene,
    against the JAX Trainer on the same schedule with the same k-means
    seeds: the same views and losses through the first stage-2.1 step, the
    same stages and root round robin after, and the artifacts: the leaf
    codebook beside the PLY and cluster_lang.npz."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    opt = dict(iterations=14, start_ins_feat_iter=4, start_root_cb_iter=8,
               start_leaf_cb_iter=11, root_node_num=K1, leaf_node_num=K2, leaf_update_fr=2)

    def seeds(feat, weight, k, *_):
        return feat[:k]  # deterministic k-means++ stand-in for both packages

    monkeypatch.setattr(jkm, "init_centers_from_points", seeds)
    monkeypatch.setattr(tkm, "init_centers_from_points", seeds)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"), rcfg=XLA, autotune_budgets=False)
    jtr.save_intermediate = False
    jtr.use_frozen_plans = False
    jtr.train(until=14, log_every=1)
    j_lang = jtr.run_stage3()
    out = str(tmp_path / "port")
    flags = [x for k, v in opt.items() for x in (f"--{k}", str(v))]

    def opt_out_trainer(*a, **kw):  # the JAX trainer's opt-out, as above
        tr = tloop.Trainer(*a, autotune_budgets=False, **kw)
        tr.use_frozen_plans = False
        return tr

    monkeypatch.setattr(tcli_train, "Trainer", opt_out_trainer)
    tr = tcli_train.main(["-s", root, "-m", out, *flags], device="cpu",
                         rcfg=TRaster(max_per_tile=1024, chunk=32))
    j_loss = np.array([r["loss"] for r in jtr.history])
    t_loss = torch.stack(tr.losses).numpy()
    assert len(t_loss) == 14 and np.isfinite(t_loss).all() and (t_loss >= 0).all()
    np.testing.assert_allclose(t_loss[:9], j_loss[:9], rtol=1e-4)
    assert [r["root_id"] for r in jtr.history[11:]] == [0, 1, 1]
    assert tr.root_id == jtr.root_id == 1
    assert tr.history[-1]["stage"] == "2.2" and tr.history[-1]["root_id"] == 1
    np.testing.assert_array_equal(tr.kms.leaf_sub_num.numpy(), np.asarray(jtr.kms.leaf_sub_num))
    n_alive = int(tr.state.num_alive)
    pc = os.path.join(out, "point_cloud", "iteration_14")
    centers, ids = codebook.load_codebook(os.path.join(pc, "leaf_code_book"))
    assert centers.shape == (K1 * K2 + 1, 6) and len(ids) == n_alive
    assert codebook.load_codebook(os.path.join(pc, "root_code_book"))[0].shape == (K1, 9)
    z = np.load(os.path.join(out, "cluster_lang.npz"))
    assert sorted(z.files) == sorted(j_lang)
    for k in z.files:
        assert z[k].shape == j_lang[k].shape, k
        assert np.isfinite(z[k]).all(), k
    assert z["leaf_feat"].shape == (K1 * K2, 512) and len(z["leaf_ind"]) == n_alive
