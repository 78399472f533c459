"""The port's default trainer is the JAX package's default trainer.

Both `Trainer`s default to fixed budgets (`autotune_budgets=True`), frozen
plans (`use_frozen_plans = True`) and no blocks (`BLOCK_SIZES = ()`); this
holds the defaults equal, runs the two trainers at their defaults side by
side (the JAX trainer on the Pallas path in interpret mode, where it builds
plans), holds the frozen-plan memory cap against both packages' estimates,
and runs `cli.train` at its defaults. CPU, small: 4 views at 64x48.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import FrozenPlan
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import loop as tloop
from tests.test_data import make_colmap_scene

# the same base config in both packages; the JAX trainer on its Pallas path
# (interpret mode on the CPU), the one that builds frozen plans
BASE = dict(max_per_tile=128, chunk=32, min_intersections=4096)
# stage 0 to 6 with a densify event after step 4 (clones only: the
# percent_dense threshold holds every splat, so no split draws noise) on a
# table whose 200 slots are all alive, so it doubles the capacity first;
# stage 1 to 10; stage 2.1 from 11 (sweep 1, the root k-means and the group
# budgets at its entry) to 16
OPT = dict(iterations=16, start_ins_feat_iter=6, start_root_cb_iter=10,
           start_leaf_cb_iter=100, densify_from_iter=2, densification_interval=4,
           densify_until_iter=5, densify_grad_threshold=1e-6, percent_dense=100.0,
           opacity_reset_interval=10_000, sam_level=3, root_node_num=4, leaf_node_num=2)
BUDGETS = ("intersection_budget", "max_per_tile", "group_intersection_budget",
           "group_max_per_tile")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_tables(monkeypatch):
    """Capacities rounded to 8 slots in both packages (200 points -> 200),
    so that the first densify event grows the table; k-means++ seeds
    feat[:k] in both."""
    for mod in (TG, JG):
        monkeypatch.setattr(mod, "round_capacity",
                            lambda n, multiple=8, _f=mod.round_capacity: _f(n, multiple))

    def seeds(feat, weight, k, *_):
        return feat[:k]  # deterministic k-means++ stand-in for both packages

    monkeypatch.setattr(jkm, "init_centers_from_points", seeds)
    monkeypatch.setattr(tkm, "init_centers_from_points", seeds)


def trainers(tmp_path, opt: dict, **jax_base):
    """The JAX and the port Trainer at their defaults on one 4-view scene."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"),
                        rcfg=JRaster(**BASE, backend="pallas", **jax_base), seed=3)
    ttr = tloop.Trainer(tdataset.load_scene(root), TConfig(opt=TOpt(**opt)),
                        str(tmp_path / "port"), rcfg=TRaster(**BASE, **jax_base), seed=3,
                        device="cpu")
    jtr.save_intermediate = ttr.save_intermediate = False
    return jtr, ttr


def test_defaults_equal(tmp_path):
    """Each shared parameter of the two Trainer.__init__ has one default; a
    constructed trainer's use_frozen_plans, BLOCK_SIZES and
    frozen_plan_bytes_cap equal the JAX trainer's; the RasterizeConfig
    fields both packages have default alike."""
    tp = inspect.signature(tloop.Trainer.__init__).parameters
    jp = inspect.signature(jloop.Trainer.__init__).parameters
    shared = [k for k in tp if k in jp]
    assert {"rcfg", "seed", "mesh", "autotune_budgets"} <= set(shared)
    for k in shared:
        assert tp[k].default == jp[k].default, k
    assert tp["autotune_budgets"].default is True
    jtr, ttr = trainers(tmp_path, dict(iterations=2))
    for k in ("use_frozen_plans", "BLOCK_SIZES", "frozen_plan_bytes_cap", "autotune_budgets"):
        assert getattr(ttr, k) == getattr(jtr, k), k
    assert ttr.use_frozen_plans is True and ttr.BLOCK_SIZES == ()
    tf = {f.name: f.default for f in dataclasses.fields(TRaster)}
    jf = {f.name: f.default for f in dataclasses.fields(JRaster)}
    assert set(tf) <= set(jf)
    assert {k: tf[k] for k in tf} == {k: jf[k] for k in tf}


def test_default_trainers_match(tmp_path, small_tables):
    """Both trainers at their defaults through a capacity growth, stage 1
    and stage-2.1 entry: the same budgets after every step (the frame
    re-tunes at the start and after the growth, the group budgets at
    stage-2.1 entry), plans built in both with the same tiles' counts, the
    same alive splats and the losses to 1e-4."""
    jtr, ttr = trainers(tmp_path, OPT)
    seen = []
    for it in range(1, OPT["iterations"] + 1):
        jtr.train(until=it, log_every=1)
        ttr.train(until=it, log_every=1)
        j = tuple(getattr(jtr.rcfg, k) for k in BUDGETS)
        t = tuple(getattr(ttr.rcfg, k) for k in BUDGETS)
        assert t == j, (it, t, j)
        assert ttr.state.capacity == jtr.state.capacity, it
        if not seen or seen[-1] != t:
            seen.append(t)
    assert ttr.state.capacity == 400  # the growth happened
    assert len(seen) >= 3, seen  # the first probe, the growth's, stage 2.1's groups
    assert seen[-1][2] > 0  # the group budgets were probed
    assert int(ttr.state.num_alive) == int(jtr.state.num_alive)
    assert isinstance(ttr._frozen_plans, FrozenPlan)
    jp = jtr._frozen_plans
    assert jp is not None and jp is not False
    np.testing.assert_array_equal(ttr._frozen_plans.counts.numpy(), np.asarray(jp.counts))
    assert [r["stage"] for r in ttr.history] == [r["stage"] for r in jtr.history]
    np.testing.assert_allclose([r["loss"] for r in ttr.history],
                               [r["loss"] for r in jtr.history], rtol=1e-4)


def test_frozen_plan_cap(tmp_path):
    """A cap between V * 4 * (P + 2T), which leaves out the reduce's order
    a plan holds, and the JAX trainer's estimate, V * 4 * (P + 2 (P + 8K)),
    turns plans off in both trainers; a cap above both builds them in both,
    and the port's stack weighs no more than its estimate."""
    opt = dict(iterations=4, start_ins_feat_iter=2, start_root_cb_iter=100,
               start_leaf_cb_iter=200, densify_until_iter=0, sam_level=3)
    jtr, ttr = trainers(tmp_path, opt)
    for tr in (jtr, ttr):
        tr.train(until=2, log_every=1)  # stage 0, at the tuned budgets
    rc = ttr.rcfg
    assert rc.intersection_budget > 0 and jtr.rcfg.intersection_budget == rc.intersection_budget
    V, n = ttr.bundle.num_views, ttr.state.capacity
    T = -(-ttr.bundle.width // 16) * -(-ttr.bundle.height // 16)
    P = rc.max_intersections(n)
    old, jax_est = V * 4 * (P + 2 * T), V * 4 * (P + 2 * (P + 8 * rc.max_per_tile))
    assert old < jax_est
    for tr in (jtr, ttr):
        tr.frozen_plan_bytes_cap = (old + jax_est) // 2
        assert tr._ensure_frozen_plans() is None and tr._frozen_plans is False
    est = tloop.frozen_plan_estimate(rc, V, n, T)
    assert est >= jax_est
    for tr in (jtr, ttr):
        tr._frozen_plans = None
        tr.frozen_plan_bytes_cap = max(est, jax_est) + 1
        assert tr._ensure_frozen_plans() is not None
    plans = ttr._frozen_plans
    assert isinstance(plans, FrozenPlan)
    assert plans.nbytes() <= est
    assert plans.nbytes() == tloop.plan_stack_bytes(rc, V, n, T)
    assert ttr.frozen_plan_log[-1]["nbytes"] == plans.nbytes()


def test_cli_train_defaults(tmp_path):
    """cli.train.main at its defaults on the CPU: the trainer it returns
    tuned its budgets and holds a FrozenPlan in stage 1."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    tr = tcli_train.main(["-s", root, "-m", str(tmp_path / "m"), "--iterations", "5",
                          "--start_ins_feat_iter", "3", "--start_root_cb_iter", "100",
                          "--start_leaf_cb_iter", "200", "--disable_intermediate_dumps"],
                         device="cpu")
    assert tr.iteration == 5 and tr.autotune_budgets and tr.use_frozen_plans
    assert tr.rcfg.intersection_budget > 0 and tr.budget_log
    assert isinstance(tr._frozen_plans, FrozenPlan)
    assert tr._frozen_plans.counts.shape[0] == tr.bundle.num_views
