"""The port's feature stages (train/loop.py: stage1_step, stage21_step and
the Trainer through stage 2.1) against the JAX package's.

The JAX side runs its Pallas kernels in interpret mode (backend="pallas")
with budgets that drop and truncate nothing, and no frozen plans (the port
has none; frozen plans deviate where the rescale factor is below 1). The
port runs the plain versions of its kernels on the CPU, in both input
layouts.

Traps to rule out before filing a mismatch as a fault:
  * RNG: the k-means++ seeds come from each package's own generator; the
    trainer test gives both the same deterministic seeds.
  * Stage 2.x trajectories: the silhouette > 0.7 gate and the k-means argmin
    fork long runs on tiny differences, so past the first stage-2.1 steps
    the runs are compared by regime, not value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu.train import pseudo as jpseudo
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import loop as tloop
from opengaussian_tpu_torch.train import pseudo as tpseudo
from opengaussian_tpu_torch.utils import codebook
from tests.test_data import make_colmap_scene
from tests.test_torch_train import FIELDS, normalised_close, toy_training_state

torch.set_num_threads(1)

W, H = 64, 48
GEOMETRY = tuple(k for k in FIELDS if k != "ins_feat")


def jax_rcfg(layout):
    return JRaster(max_per_tile=256, chunk=32, min_intersections=16384, backend="pallas",
                   pallas_input=layout)


def bundles(with_alpha: bool):
    """One 64x48 view with four SAM masks (and an alpha mask), in both
    packages' ViewBundles."""
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)
    rng = np.random.default_rng(1)
    ids = (np.arange(W)[None, :] // 32 + 2 * (np.arange(H)[:, None] // 24) + 1)
    ids = np.where(rng.uniform(size=(H, W)) < 0.1, 0, ids).astype(np.int32)
    alpha = rng.uniform(0.5, 1.0, (H, W)).astype(np.float32)
    gt = rng.uniform(0.2, 0.8, (H, W, 3)).astype(np.float32)
    common = dict(width=W, height=H, max_masks=8)
    jb = jloop.ViewBundle(
        R=cam.R_w2c[None], t=cam.t_w2c[None], fx=jnp.asarray([cam.fx]),
        fy=jnp.asarray([cam.fy]), cx=jnp.asarray([cam.cx]), cy=jnp.asarray([cam.cy]),
        gt_images=jnp.asarray(gt)[None], alpha_masks=jnp.asarray(alpha)[None],
        has_alpha=jnp.asarray([with_alpha]), sam_ids=jnp.asarray(ids)[None], **common)
    tb = tloop.ViewBundle(
        R=torch.tensor(np.asarray(cam.R_w2c))[None], t=torch.tensor(np.asarray(cam.t_w2c))[None],
        fx=torch.tensor([float(cam.fx)]), fy=torch.tensor([float(cam.fy)]),
        cx=torch.tensor([float(cam.cx)]), cy=torch.tensor([float(cam.cy)]),
        gt_images=torch.tensor(gt)[None], alpha_masks=torch.tensor(alpha)[None],
        has_alpha=torch.tensor([with_alpha]), sam_ids=torch.tensor(ids)[None], **common)
    return cam, jb, tb


def port_copies(state, adam):
    t_state = TG.state_from_numpy({k: np.asarray(getattr(state, k))
                                   for k in FIELDS + ("alive",)}, device="cpu")
    t_adam = TG.adam_from_numpy({k: np.asarray(v) for k, v in adam.mu.items()},
                                {k: np.asarray(v) for k, v in adam.nu.items()},
                                int(adam.count), device="cpu")
    return t_state, t_adam


def check_update(t_state, t_adam, t_new, t_adam2, j_state, j_adam):
    """ins_feat and its moments as the JAX step left them; the geometry bit
    for bit as it was."""
    for k in FIELDS:
        normalised_close(getattr(t_new, k), getattr(j_state, k), 1e-3, f"param {k}")
        normalised_close(t_adam2.mu[k], j_adam.mu[k], 1e-3, f"mu {k}")
        normalised_close(t_adam2.nu[k], j_adam.nu[k], 1e-3, f"nu {k}")
    for k in GEOMETRY:
        assert torch.equal(getattr(t_new, k), getattr(t_state, k)), k
    assert float((t_new.ins_feat - t_state.ins_feat).abs().max()) > 0
    assert t_adam2.count == int(j_adam.count) == t_adam.count + 1


@pytest.mark.parametrize("layout", ["stream", "dense"])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_stage1_step_matches_jax(layout, with_alpha):
    state, adam, _ = toy_training_state()
    cam, jb, tb = bundles(with_alpha)
    t_state, t_adam = port_copies(state, adam)
    it, rescale = 30_001, 0.8
    j_state, j_adam, j_loss, j_lost = jloop.stage1_step(
        state, adam, jb, jnp.int32(0), jnp.int32(it), jnp.zeros(3), jnp.float32(rescale),
        jax_rcfg(layout), JOpt(), with_alpha)
    t_new, t_adam2, loss, lost = tloop.stage1_step(
        t_state, t_adam, tb, 0, it, torch.zeros(3), rescale,
        TRaster(max_per_tile=256, chunk=32, pallas_input=layout), TOpt(), with_alpha)
    assert int(lost) == int(j_lost) == 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    check_update(t_state, t_adam, t_new, t_adam2, j_state, j_adam)


@pytest.mark.parametrize("layout", ["stream", "dense"])
def test_stage21_step_matches_jax(layout, monkeypatch):
    """From the same state, root codebook and sweep-1 pseudo labels."""
    state, adam, _ = toy_training_state()
    cam, jb, tb = bundles(False)
    seeds = np.concatenate([np.asarray(state.ins_feat), np.asarray(state.means)], 1)[:8]
    monkeypatch.setattr(jkm, "init_centers_from_points", lambda *a: jnp.asarray(seeds))
    kms = jkm.assign_root(jkm.KMeansState.create(state.capacity, 8, 5), state.ins_feat,
                          state.means, state.alive, 1.0, jax.random.PRNGKey(0), init=True)
    pl = jpseudo.construct_pseudo_labels(state, [cam], jb.sam_ids, jnp.zeros(3), 8,
                                         jax_rcfg(layout))
    t_state, t_adam = port_copies(state, adam)
    t_kms = tkm.kmeans_from_numpy({f: np.asarray(getattr(kms, f)) for f in kms._fields},
                                  device="cpu")
    t_pl = tpseudo.pseudo_from_numpy(np.asarray(pl.feat), np.asarray(pl.mask_ids), "cpu")
    it, rescale = 40_001, 0.7
    j_state, j_adam, j_loss, j_lost = jloop.stage21_step(
        state, adam, kms, jb, jnp.int32(0), jnp.int32(it), jnp.zeros(3),
        jnp.float32(rescale), pl.feat[0], jax_rcfg(layout), JOpt())
    t_new, t_adam2, loss, lost = tloop.stage21_step(
        t_state, t_adam, t_kms, tb, 0, it, torch.zeros(3), rescale, t_pl.feat[0],
        TRaster(max_per_tile=256, chunk=32, pallas_input=layout), TOpt())
    assert int(lost) == int(j_lost) == 0
    assert float(j_loss) > 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    check_update(t_state, t_adam, t_new, t_adam2, j_state, j_adam)


def test_trainer_through_stage21_matches_jax(tmp_path, monkeypatch):
    """12 iterations on make_colmap_scene: stage 0 to 4, stage 1 to 8,
    sweep 1 and the root k-means at 9, stage 2.1 to 12. Both trainers visit
    the same views and draw the same rescale factors; both k-means start
    from the same seeds. Losses agree step for step through stage 1 and the
    first stage-2.1 step; past it, by regime. The dense layout's run equals
    the stream layout's."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4)
    opt = dict(iterations=12, start_ins_feat_iter=4, start_root_cb_iter=8,
               start_leaf_cb_iter=12, root_node_num=8)

    def seeds(feat, weight, k, *_):
        return feat[:k]  # deterministic k-means++ stand-in for both packages

    monkeypatch.setattr(jkm, "init_centers_from_points", seeds)
    monkeypatch.setattr(tkm, "init_centers_from_points", seeds)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"), rcfg=jax_rcfg("stream"),
                        autotune_budgets=False)
    jtr.save_intermediate = False
    jtr.use_frozen_plans = False
    jtr.train(until=12, log_every=1)
    runs = {}
    for layout in ("stream", "dense"):
        tr = tloop.Trainer(tdataset.load_scene(root), TConfig(opt=TOpt(**opt)),
                           str(tmp_path / layout),
                           rcfg=TRaster(max_per_tile=1024, chunk=32, pallas_input=layout),
                           device="cpu", autotune_budgets=False)
        tr.use_frozen_plans = False  # the JAX trainer's opt-out, as above
        tr.train(until=4, log_every=1)
        geometry = {k: getattr(tr.state, k).clone() for k in GEOMETRY}
        tr.train(until=12, log_every=1)
        for k in GEOMETRY:
            assert torch.equal(getattr(tr.state, k), geometry[k]), k
        tr.save()
        runs[layout] = tr
    tr = runs["stream"]
    j_loss = np.array([r["loss"] for r in jtr.history])
    t_loss = np.array([r["loss"] for r in tr.history])
    assert [r["stage"] for r in tr.history] == [r["stage"] for r in jtr.history] == \
        ["0"] * 4 + ["1"] * 4 + ["2.1"] * 4
    np.testing.assert_allclose(t_loss[:9], j_loss[:9], rtol=1e-4)
    assert np.isfinite(t_loss).all() and (t_loss[8:] >= 0).all()
    assert np.abs(t_loss[8:] - j_loss[8:]).max() < 0.1 * max(j_loss[8:].max(), 1e-3)
    np.testing.assert_allclose(np.array([r["loss"] for r in runs["dense"].history]),
                               t_loss, rtol=1e-5)
    # the codebooks: the same clustering, and the saved artifact
    np.testing.assert_allclose(tr.kms.centers.numpy(), np.asarray(jtr.kms.centers),
                               atol=1e-4)
    agree = (tr.kms.cls_ids.numpy() == np.asarray(jtr.kms.cls_ids))[tr.state.alive.numpy()]
    assert agree.mean() > 0.99
    centers, ids = codebook.load_codebook(
        str(tmp_path / "stream/point_cloud/iteration_12/root_code_book"))
    assert centers.shape == (8, 9) and len(ids) == int(tr.state.num_alive)
    np.testing.assert_allclose(
        tr.pseudo.feat.numpy(), np.asarray(jtr.pseudo.feat), atol=3e-5, rtol=1e-4)
