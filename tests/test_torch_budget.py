"""Fixed budgets: the port's ops/budget.py, bin_gaussians at a fixed slot
budget P and the trainer's re-probe, against the JAX package
(ops/budget.py, bin_gaussians, tests/test_budget.py's cases) on the CPU.

The JAX side runs its XLA path (backend "auto" on the CPU), where
tuned_config never takes its tile-window branch; the port has none.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models.gaussians import create_from_pcd as jcreate
from opengaussian_tpu.ops import binning as jbin
from opengaussian_tpu.ops import budget as jbudget
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import binning as tbin
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

FIELDS = ("means", "sh_dc", "sh_rest", "logit_opacity", "log_scales", "quats", "ins_feat",
          "alive")


def small_scene(n=400):
    """tests/test_budget.py:small_scene in both packages."""
    rng = np.random.default_rng(3)
    pts = np.stack([rng.normal(0, 0.4, n), rng.normal(0, 0.3, n),
                    rng.uniform(2, 5, n)], -1).astype(np.float32)
    st = jcreate(pts, rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=n, seed=0)
    st = dataclasses.replace(
        st, log_scales=jnp.full_like(st.log_scales, np.log(0.05)),
        logit_opacity=jnp.asarray(rng.normal(0, 1, n).astype(np.float32)))
    tst = TG.state_from_numpy({k: np.asarray(getattr(st, k)) for k in FIELDS},
                              device="cpu")
    return st, tst


def cams(w=160, h=120):
    return (JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h),
            Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h))


@pytest.mark.parametrize("headroom", [1.3, 1.05])
def test_tuned_configs_match_jax(headroom):
    """The probe, tuned_config and tuned_group_config give the JAX package's
    numbers on one state; the tuned budgets render the base config's image
    with nothing dropped or truncated (tests/test_budget.py:27, :46)."""
    jst, tst = small_scene()
    jc, tc = cams()
    jbase = jrast.RasterizeConfig(max_per_tile=512, chunk=32, min_intersections=4096)
    base = RasterizeConfig(max_per_tile=512, chunk=32, min_intersections=4096)
    assert budget.probe(tst, [tc]) == jbudget.probe(jst, [jc])
    jt = jbudget.tuned_config(jbase, jst, [jc], headroom=headroom)
    tt = budget.tuned_config(base, tst, [tc], headroom=headroom)
    assert (tt.intersection_budget, tt.max_per_tile) == (jt.intersection_budget,
                                                         jt.max_per_tile)
    assert tt.max_intersections(400) == jt.max_intersections(400)
    cls = np.random.default_rng(1).integers(0, 5, 400).astype(np.int32)
    jg = jbudget.tuned_group_config(jt, jst, [jc], jnp.asarray(cls), 5, headroom=headroom)
    tg = budget.tuned_group_config(tt, tst, [tc], torch.as_tensor(cls), 5,
                                   headroom=headroom)
    assert (tg.group_intersection_budget, tg.group_max_per_tile) == (
        jg.group_intersection_budget, jg.group_max_per_tile)
    assert tg.group_config().max_per_tile == tg.group_max_per_tile
    cov = tproj.build_cov3d(tst.scales, tst.quats)
    pay = tst.sh_dc[:, 0]
    full = rasterize(tc, tst.means, cov, tst.opacity, pay, torch.zeros(3), base)
    tun = rasterize(tc, tst.means, cov, tst.opacity, pay, torch.zeros(3), tt)
    assert int(tun.n_dropped) == 0 and int(tun.n_truncated) == 0
    np.testing.assert_allclose(tun.image.numpy(), full.image.numpy(), rtol=1e-6, atol=1e-6)


def _projections(P_scene_seed=5, n=300, w=96, h=64):
    rng = np.random.default_rng(P_scene_seed)
    means = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                      rng.uniform(2, 5, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-2.3, 0.4, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.1, 0.95, n).astype(np.float32)
    cov = np.asarray(jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats)))
    jc, tc = cams(w, h)
    pj = jproj.project(jnp.asarray(means), jnp.asarray(cov), jc, opacities=jnp.asarray(op))
    pt = tproj.project(torch.as_tensor(means), torch.as_tensor(cov), tc,
                       opacities=torch.as_tensor(op))
    return (means, cov, op), (jc, tc), pj, pt


@pytest.mark.parametrize("P", [900, 1500])
def test_fixed_budget_drops_as_jax(P):
    """At a budget P below the frame's intersections the port drops the
    slots past P in splat order, as the JAX package does: the same
    n_dropped, counts and tile runs, the dropped and culled slots past the
    last tile with id n, and the same image."""
    (means, cov, op), (jc, tc), pj, pt = _projections()
    gx, gy = 6, 4
    a = jbin.bin_gaussians(pj, gx, gy, P, 256, dense=False, stream=True)
    b = tbin.bin_gaussians(pt, gx, gy, 256, max_intersections=P)
    n = means.shape[0]
    assert int(a.total) > P and int(b.n_dropped) == int(a.n_dropped) > 0
    assert int(b.n_truncated) == int(a.n_truncated)
    np.testing.assert_array_equal(b.counts.numpy(), np.asarray(a.counts))
    np.testing.assert_array_equal(b.tile_start.numpy(), np.asarray(a.tile_start))
    assert b.sorted_gauss.shape == (P,)
    live = np.zeros(P, bool)
    for t0, c in zip(np.asarray(a.tile_start), np.asarray(a.counts)):
        live[t0:t0 + c] = True
    np.testing.assert_array_equal(b.sorted_gauss.numpy()[live],
                                  np.asarray(a.sorted_gauss)[live])
    end = int(b.tile_start[-1] + b.counts[-1])
    assert (b.sorted_gauss.numpy()[end:] == n).all()
    pay = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    jcfg = jrast.RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=256,
                                 intersection_budget=P)
    ja = jrast.rasterize(jc, jnp.asarray(means), jnp.asarray(cov), jnp.asarray(op),
                         jnp.asarray(pay), jnp.zeros(3), jcfg)
    for layout in ("stream", "dense"):
        tcfg = RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=256,
                               intersection_budget=P, pallas_input=layout)
        tb = rasterize(tc, torch.as_tensor(means), torch.as_tensor(cov), torch.as_tensor(op),
                       torch.as_tensor(pay), torch.zeros(3), tcfg)
        assert int(tb.n_dropped) == int(ja.n_dropped)
        np.testing.assert_allclose(tb.image.numpy(), np.asarray(ja.image), atol=3e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("layout,bwd", [("stream", "auto"), ("stream", "compact"),
                                        ("dense", "auto")])
def test_fixed_budget_equals_per_frame_stream(layout, bwd):
    """With a budget that drops nothing, the fixed-P stream renders and
    differentiates as the stream sized per frame, in every layout: its
    extra slots sit past the last tile with id n."""
    (means, cov, op), (_, tc), _, _ = _projections(n=250)
    n = means.shape[0]
    pay = np.random.default_rng(4).uniform(size=(n, 4)).astype(np.float32)
    outs = []
    for budget_p in (0, 6000):
        cfg = RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=1024,
                              intersection_budget=budget_p, pallas_input=layout,
                              bwd_layout=bwd)
        m, p, o = (torch.as_tensor(x).requires_grad_(True) for x in (means, pay, op))
        r = rasterize(tc, m, torch.as_tensor(cov), o, p, torch.zeros(4), cfg)
        w = torch.linspace(-1, 1, r.image.numel()).reshape(r.image.shape)
        loss = (r.image * w).sum() + r.alpha.sum() * 0.1 + r.depth.sum() * 0.01
        outs.append((r, torch.autograd.grad(loss, [m, p, o])))
    assert int(outs[1][0].n_dropped) == 0
    assert torch.equal(outs[1][0].image, outs[0][0].image)
    for a, b, name in zip(outs[1][1], outs[0][1], ("means", "payload", "opacity")):
        assert_normalised(a, b, 1e-5, name)


def test_probe_escalates_past_its_own_cap():
    """tests/test_budget.py:111: every splat on one spot, so one tile holds
    all n > PROBE_K of them; the probe doubles its cap until its count is
    not its own truncation, and tuned_config grows K past a small base."""
    n = 4096
    rng = np.random.default_rng(7)
    pts = np.stack([rng.normal(0, 1e-4, n), rng.normal(0, 1e-4, n),
                    np.full(n, 3.0)], -1).astype(np.float32)
    st = TG.create_from_pcd(pts, rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=n,
                            seed=0, device="cpu")
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48)
    total, cnt = budget.probe(st, [cam])
    assert cnt > budget.PROBE_K and cnt == n
    base = RasterizeConfig(max_per_tile=256, chunk=64, min_intersections=8192)
    assert budget.tuned_config(base, st, [cam]).max_per_tile >= cnt


def test_stage1_reports_lost_and_trainer_reprobes(tmp_path, capsys):
    """tests/test_budget.py:63: budgets strangled in stage 1 lose slots; the
    logged step warns, the trainer re-probes, and later steps run clean past
    the base config's per-tile cap."""
    from opengaussian_tpu_torch.config import Config, ModelConfig, OptimizationConfig
    from opengaussian_tpu_torch.data import dataset
    from opengaussian_tpu_torch.train.loop import Trainer
    from tests.test_data import make_colmap_scene

    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    tiny = OptimizationConfig(
        iterations=8, start_ins_feat_iter=2, start_root_cb_iter=100,
        start_leaf_cb_iter=200, densify_from_iter=100, densify_until_iter=0,
        root_node_num=4, leaf_node_num=3, sam_level=3)
    tr = Trainer(dataset.load_scene(root), Config(model=ModelConfig(), opt=tiny),
                 str(tmp_path / "out"),
                 rcfg=RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=8192),
                 device="cpu")
    tr.save_intermediate = False
    tr.train(until=2, log_every=1)
    tr.rcfg = RasterizeConfig(max_per_tile=16, chunk=16, min_intersections=256,
                              intersection_budget=256)
    tr.autotune_budgets = True
    tr._budgets_tuned = True
    tr.train(until=4, log_every=1)
    out = capsys.readouterr().out
    assert "WARNING" in out and "re-probing" in out
    tr.train(until=6, log_every=1)
    out = capsys.readouterr().out
    assert "WARNING" not in out
    assert tr._budgets_tuned
    assert tr.rcfg.max_intersections(tr.state.capacity) > 256
