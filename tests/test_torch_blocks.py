"""Blocks of steps (Trainer.BLOCK_SIZES) and the captured step's static
path, against the JAX package's blocked trainer (tests/test_trainer.py:134's
bounds, on fewer iterations) and the port's own eager steps, on the CPU.

On the CPU a block runs the captured step's body eagerly on its static
buffers: the same code a CUDA graph captures on the card, where
tests/test_torch_gpu.py holds the replays against the eager steps.

Traps: the k-means++ seeds come from each package's own generator, so both
get the same deterministic seeds; a block draws its views, then its
backgrounds, then its rescale factors (the JAX package's order), so it is
held against the JAX package's blocks, not against single steps, past
stage 0; stages 2.x fork on hard gates, so there the runs are compared by
regime.
"""

import dataclasses

import numpy as np
import pytest
import torch

from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu_torch.config import Config, OptimizationConfig
from opengaussian_tpu_torch.data import dataset
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.train import loop as tloop
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

OPT = dict(iterations=40, start_ins_feat_iter=10, start_root_cb_iter=20,
           start_leaf_cb_iter=30, densify_from_iter=1000, densify_until_iter=0,
           opacity_reset_interval=10_000, sam_level=3, root_node_num=4, leaf_node_num=3,
           leaf_update_fr=4)
RCFG = dict(max_per_tile=128, chunk=32, min_intersections=8192)
BLOCKS = (50, 10, 5)


def _seeds(feat, weight, k, *_):
    return feat[:k]  # a deterministic k-means++ stand-in for both packages


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's and the JAX package's blocked trainers, and the port's
    single-step trainer, through stage 0 (kept) and then to iteration 40."""
    tmp = tmp_path_factory.mktemp("blocks")
    root = str(tmp / "scene")
    make_colmap_scene(root, n_views=4)
    mp = pytest.MonkeyPatch()
    mp.setattr(jkm, "init_centers_from_points", _seeds)
    mp.setattr(tkm, "init_centers_from_points", _seeds)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**OPT)),
                        str(tmp / "jax"), rcfg=JRaster(**RCFG), seed=3)
    jtr.save_intermediate = False
    jtr.BLOCK_SIZES = BLOCKS

    def port(block: bool):
        tr = tloop.Trainer(dataset.load_scene(root), Config(opt=OptimizationConfig(**OPT)),
                           str(tmp / f"port_{block}"), rcfg=RasterizeConfig(**RCFG), seed=3,
                           device="cpu", autotune_budgets=True)
        tr.save_intermediate = False
        if block:
            tr.BLOCK_SIZES = BLOCKS
        return tr

    a, b = port(True), port(False)
    out = {}
    for name, tr in (("jax", jtr), ("port", a), ("single", b)):
        tr.train(until=10, log_every=200)
        out[name + "_stage0"] = {k: np.asarray(getattr(tr.state, k)).copy()
                                 for k in ("means", "logit_opacity", "ins_feat")}
    for tr in (jtr, a):
        tr.train(until=20, log_every=200)
    out["jax_stage1"] = np.asarray(jtr.state.ins_feat).copy()
    out["port_stage1"] = a.state.ins_feat.numpy().copy()
    for tr in (jtr, a):
        tr.train(until=40, log_every=200)
    mp.undo()
    out.update(jax=jtr, port=a, single=b)
    return out


def test_blocks_match_jax_through_every_stage(runs):
    """tests/test_trainer.py:134's bounds: through stage 1 the geometry to
    rtol 1e-5 / atol 1e-6 and ins_feat to 1e-5; at iteration 40 (stage 2.2)
    the frozen geometry still equal, ins_feat within 0.05, the same root
    assignment. The block schedule and budgets are the JAX trainer's."""
    a, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(runs["port_stage0"]["means"], runs["jax_stage0"]["means"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(runs["port_stage1"], runs["jax_stage1"], atol=1e-5)
    assert a.iteration == j.iteration == 40 and a._stage(a.iteration) == "2.2"
    assert (a.rcfg.intersection_budget, a.rcfg.max_per_tile) == (
        j.rcfg.intersection_budget, j.rcfg.max_per_tile)
    assert (a.rcfg.group_intersection_budget, a.rcfg.group_max_per_tile) == (
        j.rcfg.group_intersection_budget, j.rcfg.group_max_per_tile)
    np.testing.assert_allclose(a.state.logit_opacity.numpy(),
                               np.asarray(j.state.logit_opacity), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.state.ins_feat.numpy(), np.asarray(j.state.ins_feat),
                               atol=0.05)
    assert np.array_equal(a.kms.cls_ids.numpy(), np.asarray(j.kms.cls_ids))
    assert a.root_id == j.root_id
    assert len(a.losses) == 40 and all(np.isfinite(float(x)) for x in a.losses)


def test_blocks_equal_single_steps_through_stage0(runs):
    """Stage 0 draws the same views in a block as in single steps (no
    random background), and the block's static body is the eager step:
    the geometry after stage 0 is bit for bit the single-step run's."""
    for k in ("means", "logit_opacity", "ins_feat"):
        assert np.array_equal(runs["port_stage0"][k], runs["single_stage0"][k]), k


def test_block_len_matches_jax(tmp_path):
    """The block schedule (pre and post events, stage boundaries, the menu
    of lengths) is the JAX trainer's, iteration by iteration, on a schedule
    with densification, opacity resets and logging."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    opt = dict(OPT, iterations=400, start_ins_feat_iter=120, start_root_cb_iter=210,
               start_leaf_cb_iter=300, densify_from_iter=20, densify_until_iter=100,
               densification_interval=30, opacity_reset_interval=70)
    j = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)), str(tmp_path / "j"),
                      rcfg=JRaster(**RCFG))
    t = tloop.Trainer(dataset.load_scene(root), Config(opt=OptimizationConfig(**opt)),
                      str(tmp_path / "t"), rcfg=RasterizeConfig(**RCFG), device="cpu")
    j.BLOCK_SIZES = t.BLOCK_SIZES = BLOCKS
    got = want = []
    for log_every in (200, 25):
        got = [t._block_len(i, t._stage(i), 400, log_every) for i in range(1, 401)]
        want = [j._block_len(i, j._stage(i), 400, log_every) for i in range(1, 401)]
        assert got == want
    assert set(got) == {1, 5, 10}


def test_block_needs_fixed_budgets(tmp_path):
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    tr = tloop.Trainer(dataset.load_scene(root), Config(opt=OptimizationConfig(**OPT)),
                       str(tmp_path / "out"), rcfg=RasterizeConfig(**RCFG), device="cpu")
    tr.save_intermediate = False
    tr.BLOCK_SIZES = BLOCKS
    with pytest.raises(ValueError, match="fixed budgets"):
        tr.train(until=5, log_every=200)


@pytest.mark.parametrize("stage", ["0", "1", "2.1", "2.2"])
def test_static_step_equals_eager_step(runs, stage):
    """The captured step's body on its static buffers (the per-step numbers
    read from one device row) gives the eager step's new state, moments,
    loss and lost count, bit for bit, for one step of each stage from the
    trained state (the root visible in the view, where stage 2.2 has one)."""
    tr = runs["port"]
    o = tr.cfg.opt
    it = {"0": 7, "1": 15, "2.1": 25, "2.2": 38}[stage]
    occur = tr.pseudo.cluster_occur.numpy()
    vi, root = next(((v, r) for v in range(occur.shape[0]) for r in range(occur.shape[1])
                     if occur[v, r]), (1, 2))
    rescale = 1.0 if stage == "0" else 0.7
    bg = tr.bg
    count = tr.adam.count + 1
    step = tloop._CapturedStep(tr, stage, False, None, None, ())
    step.copy_in(tr)
    loss = step.run(tr._step_row(stage, it, vi, bg, rescale, root, count))
    feat = tr.pseudo.feat[vi]
    if stage == "0":
        st, ad, _stats, e_loss, _p, e_lost = tloop.stage0_step(
            tr.state, tr.adam, tr.stats, tr.bundle, vi, it, bg, tr.spatial_lr_scale,
            tr.rcfg, o)
    elif stage == "1":
        st, ad, e_loss, e_lost = tloop.stage1_step(tr.state, tr.adam, tr.bundle, vi, it, bg,
                                                   rescale, tr.rcfg, o, tr.any_alpha)
    elif stage == "2.1":
        st, ad, e_loss, e_lost = tloop.stage21_step(tr.state, tr.adam, tr.kms, tr.bundle, vi,
                                                    it, bg, rescale, feat, tr.rcfg, o,
                                                    tr.any_alpha)
    else:
        st, ad, e_loss, ok, e_lost = tloop.stage22_step(
            tr.state, tr.adam, tr.kms, tr.bundle, vi, it, bg, rescale, feat, root,
            tr.pseudo.cluster_occur[vi, root], tr.rcfg, o, tr.any_alpha)
    assert ad.count == count
    for k, v in st.params().items():
        assert torch.equal(getattr(step.io["state"], k), v), k
        assert torch.equal(step.io["mu"][k], ad.mu[k]) and torch.equal(step.io["nu"][k],
                                                                       ad.nu[k]), k
    assert torch.equal(loss, e_loss) and int(step.io["lost"]) == int(e_lost) == 0
    if stage != "0":
        assert float((st.ins_feat - tr.state.ins_feat).abs().max()) > 0 or stage == "2.2"


def test_step_row_layout(runs):
    """The row a captured step reads: view, root, rescale, background, the
    bias corrections and their reciprocals in float32, the learning rates
    in the order of the state's leaves, the SH mask."""
    tr = runs["port"]
    row = tr._step_row("0", 2500, 3, torch.tensor([0.1, 0.2, 0.3]), 1.0, 2, 7)
    keys = list(tr.state.params())
    assert row.dtype == torch.float32
    assert row[:6].tolist() == pytest.approx([3, 2, 1.0, 0.1, 0.2, 0.3])
    c1, c2 = tloop.opt_mod.bias_corrections(7)
    assert row[6:10].tolist() == pytest.approx([c1, c2, 1 / c1, 1 / c2], rel=1e-6)
    lrs = tloop.opt_mod.learning_rates(tr.cfg.opt, 2500, tr.spatial_lr_scale)
    assert row[10:10 + len(keys)].tolist() == pytest.approx([lrs[k] for k in keys], rel=1e-6)
    assert row[10 + len(keys):].tolist() == tloop.sh_mask_values(2500, 15)
    assert tloop.sh_mask_values(2500, 15) == [1.0] * 8 + [0.0] * 7
    assert dataclasses.is_dataclass(tloop.StepHyper)
