"""Frozen plans: the port's FrozenPlan, build_frozen_plan, the rasterizer,
render_clusters and the trainer with plans, against the fresh binning and
the JAX package (tests/test_frozen.py's cases and bounds) on the CPU.

The port's reduce sums by atomics and sorts nothing, so its plans carry no
reduce plan, as the JAX package's "scatter" backend's do
(tests/test_frozen.py:217).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import create_from_pcd
from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import (
    FrozenPlan,
    RasterizeConfig,
    build_frozen_plan,
    rasterize,
    stack_plans,
)
from opengaussian_tpu_torch.render import render_clusters

torch.set_num_threads(1)

CFG = RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=4096)


def _scene(n=500, seed=0):
    """tests/test_frozen.py:_scene, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.45, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(np.log(0.13), 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(0.5, 1.5, n)))).astype(np.float32)
    payload = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, payload


def _cam():
    return Camera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 96, 80)


def _loss_outputs(cam, means, cov, opac, payload, cfg, frozen=None):
    p = torch.as_tensor(payload).requires_grad_(True)
    o = torch.as_tensor(opac).requires_grad_(True)
    out = rasterize(cam, torch.as_tensor(means), cov, o, p, torch.zeros(3), cfg,
                    frozen=frozen)
    w = torch.arange(out.image.numel(), dtype=torch.float32).reshape(out.image.shape) * 1e-3
    loss = (out.image * w).sum() + out.alpha.sum() * 0.1 + out.depth.sum() * 0.01
    return float(loss.detach()), out, torch.autograd.grad(loss, [p, o])


@pytest.mark.parametrize("budget", [0, 40000])
def test_frozen_matches_fresh(budget):
    """tests/test_frozen.py:73: the plan is the fresh binning (its stream,
    runs and counts), and the render and gradients through it equal the
    fresh ones; with a fixed budget and sized per frame."""
    means, scales, quats, opac, payload = _scene()
    cam = _cam()
    cfg = dataclasses.replace(CFG, intersection_budget=budget)
    cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    plan = build_frozen_plan(cam, torch.as_tensor(means), cov, torch.as_tensor(opac), cfg)
    proj = project(torch.as_tensor(means), cov, cam, opacities=torch.as_tensor(opac))
    bins = bin_gaussians(proj, 6, 5, cfg.max_per_tile,
                         max_intersections=cfg.fixed_budget(len(means)))
    assert torch.equal(plan.g_sorted, bins.sorted_gauss)
    assert torch.equal(plan.tstart, bins.tile_start) and torch.equal(plan.counts, bins.counts)
    l0, o0, g0 = _loss_outputs(cam, means, cov, opac, payload, cfg)
    l1, o1, g1 = _loss_outputs(cam, means, cov, opac, payload, cfg, frozen=plan)
    for k in ("image", "alpha", "depth", "radii"):
        assert torch.equal(getattr(o1, k), getattr(o0, k)), k
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=2e-5)
    assert int(o1.n_dropped) == int(o0.n_dropped) == 0
    assert int(o1.n_truncated) == int(o0.n_truncated)


def test_frozen_matches_jax_frozen():
    """The port's frozen render against the JAX package's frozen render
    (Pallas stream path in interpret mode), to the image tolerance."""
    means, scales, quats, opac, payload = _scene(n=300, seed=1)
    jcam = JCamera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48)
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48)
    jcfg = jrast.RasterizeConfig(max_per_tile=128, chunk=32, backend="pallas",
                                 min_intersections=4096, reduce_backend="scatter")
    from opengaussian_tpu.ops.projection import build_cov3d as jcov

    cov = np.asarray(jcov(jnp.asarray(scales), jnp.asarray(quats)))
    args = tuple(map(jnp.asarray, (means, cov, opac)))
    jplan = jrast.build_frozen_plan(jcam, *args, jcfg)
    ja = jrast.rasterize(jcam, *args, jnp.asarray(payload), jnp.zeros(3), jcfg,
                         frozen=jplan)
    targs = tuple(map(torch.as_tensor, (means, cov, opac)))
    plan = build_frozen_plan(cam, *targs, CFG)
    assert int(plan.total) == int(jplan.total)
    tb = rasterize(cam, *targs, torch.as_tensor(payload), torch.zeros(3), CFG, frozen=plan)
    np.testing.assert_allclose(tb.image.numpy(), np.asarray(ja.image), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(tb.alpha.numpy(), np.asarray(ja.alpha), atol=3e-5)


def test_frozen_superset_serves_rescaled_cov():
    """tests/test_frozen.py:91: a plan built at rescale 1.0 serving a render
    at 0.55, lossless: within 0.02 of the fresh image, at most 3% of pixels
    above 1e-5, gradients within 0.02 normalised."""
    means, scales, quats, opac, payload = _scene(seed=3)
    cam = _cam()
    cfg = dataclasses.replace(CFG, max_per_tile=512)
    cov1 = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    plan = build_frozen_plan(cam, torch.as_tensor(means), cov1, torch.as_tensor(opac), cfg)
    assert int(plan.n_truncated) == 0 and int(plan.n_dropped) == 0
    cov_r = build_cov3d(torch.as_tensor(scales) * 0.55, torch.as_tensor(quats))
    l0, o0, g0 = _loss_outputs(cam, means, cov_r, opac, payload, cfg)
    l1, o1, g1 = _loss_outputs(cam, means, cov_r, opac, payload, cfg, frozen=plan)
    diff = (o1.image - o0.image).abs().detach().numpy()
    assert diff.max() <= 0.02, diff.max()
    assert (diff > 1e-5).mean() <= 0.03, (diff > 1e-5).mean()
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) / (float(b.abs().max()) + 1e-12) <= 0.02


def test_cluster_render_frozen_matches_scan():
    """tests/test_frozen.py:129: stage 2.2's single-root render as a
    masked-opacity blend over the frozen stream against the per-group
    re-binning: images, silhouettes, occur and the payload gradient."""
    rng = np.random.default_rng(7)
    n = 600
    pts = np.stack([rng.normal(0, .6, n), rng.normal(0, .45, n),
                    rng.uniform(2, 6, n)], -1).astype(np.float32)
    gs = create_from_pcd(pts, rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=n,
                         seed=0, device="cpu")
    gs = dataclasses.replace(gs, log_scales=gs.log_scales + np.log(0.3),
                             ins_feat=torch.as_tensor(
                                 rng.uniform(-1, 1, (n, 6)).astype(np.float32)))
    cam = _cam()
    cls = torch.as_tensor((pts[:, 0] > 0).astype(np.int32))
    cfg = RasterizeConfig(max_per_tile=512, chunk=32, min_intersections=8192)
    plan = build_frozen_plan(cam, gs.means, build_cov3d(gs.scales, gs.quats), gs.opacity,
                             cfg)
    assert int(plan.n_truncated) == 0 and int(plan.n_dropped) == 0

    def run(frozen):
        feat = gs.ins_feat.clone().requires_grad_(True)
        out = render_clusters(cam, dataclasses.replace(gs, ins_feat=feat), torch.zeros(3),
                              cls, [1], cfg, min_points=1, frozen=frozen)
        (g,) = torch.autograd.grad((out.cluster_imgs[0] * 0.01).sum(), [feat])
        return out, g

    o0, g0 = run(None)
    o1, g1 = run(plan)
    np.testing.assert_allclose(o1.cluster_imgs[0].detach().numpy(),
                               o0.cluster_imgs[0].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(o1.cluster_silhouettes[0].detach().numpy(),
                               o0.cluster_silhouettes[0].detach().numpy(), atol=1e-5)
    assert bool(o1.cluster_occur[0]) == bool(o0.cluster_occur[0])
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-5, atol=2e-5)


def test_stacked_plans_select_by_device_index():
    """stack_plans pads streams of unequal length with id n; select takes a
    view by int or by a one-element index tensor, and either renders as the
    view's own plan."""
    means, scales, quats, opac, payload = _scene(n=300, seed=4)
    cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    cams = [Camera.from_fov(np.eye(3), np.asarray([dx, 0, 0], np.float32), 1.0, 0.8, 64, 48)
            for dx in (0.0, 0.3)]
    args = (torch.as_tensor(means), cov, torch.as_tensor(opac))
    plans = [build_frozen_plan(c, *args, CFG) for c in cams]
    st = stack_plans(plans, len(means))
    assert st.g_sorted.shape[0] == 2
    for i, c in enumerate(cams):
        for pick in (i, torch.tensor([i])):
            p = st.select(pick)
            assert (p.g_sorted[plans[i].g_sorted.shape[0]:] == len(means)).all()
            a = rasterize(c, *args, torch.as_tensor(payload), torch.zeros(3), CFG, frozen=p)
            b = rasterize(c, *args, torch.as_tensor(payload), torch.zeros(3), CFG,
                          frozen=plans[i])
            assert torch.equal(a.image, b.image)


def test_trainer_stage1_frozen_parity(tmp_path):
    """tests/test_frozen.py:176: the trainer with plans against the trainer
    without, through stage 1 (rescale 1, where a plan is exact): ins_feat
    within 2e-5, the plans built once, the losses those of the JAX trainer
    (no plans) to 1e-4."""
    from opengaussian_tpu.config import Config as JConfig
    from opengaussian_tpu.config import OptimizationConfig as JOpt
    from opengaussian_tpu.data import dataset as jdataset
    from opengaussian_tpu.train import loop as jloop
    from opengaussian_tpu_torch.config import Config, OptimizationConfig
    from opengaussian_tpu_torch.data import dataset
    from opengaussian_tpu_torch.train.loop import Trainer
    from tests.test_data import make_colmap_scene

    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4)
    opt = dict(iterations=16, start_ins_feat_iter=4, start_root_cb_iter=60,
               start_leaf_cb_iter=90, densify_from_iter=1000, densify_until_iter=0,
               opacity_reset_interval=10_000, sam_level=3, root_node_num=4,
               leaf_node_num=3, leaf_update_fr=10)
    runs = []
    for frozen in (True, False):
        tr = Trainer(dataset.load_scene(root), Config(opt=OptimizationConfig(**opt)),
                     str(tmp_path / f"out_{frozen}"), rcfg=CFG, seed=3, device="cpu",
                     autotune_budgets=True)
        tr.save_intermediate = False
        tr.use_frozen_plans = frozen
        tr.train(until=16, log_every=1)
        runs.append(tr)
    a, b = runs
    assert isinstance(a._frozen_plans, FrozenPlan) and b._frozen_plans is None
    np.testing.assert_allclose(a.state.ins_feat.numpy(), b.state.ins_feat.numpy(), atol=2e-5)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"),
                        rcfg=jrast.RasterizeConfig(max_per_tile=128, chunk=32,
                                                   min_intersections=4096), seed=3)
    jtr.save_intermediate = False
    jtr.train(until=16, log_every=1)
    np.testing.assert_allclose([r["loss"] for r in a.history],
                               [r["loss"] for r in jtr.history], rtol=1e-4)
