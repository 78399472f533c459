"""Tile windows: the port's windowed binning, `_fold_windows`, the windowed
render, partition render and FrozenPlan, the tuner's opt-in window branch and
`windowed_variant`, against the JAX package (ops/binning.py, rasterize.py,
budget.py; tests/test_windows.py's cases and bounds) on the CPU.

The JAX package's windowed render runs its Pallas stream kernels in
interpret mode (backend "pallas", as tests/test_windows.py runs them); its
unwindowed deep reference is the XLA scan (backend "xla"). Where both
packages must give the same windows, both bin at one fixed budget P, since
the window budget Tv = band + P // K depends on it.
"""

import dataclasses
import types

import jax
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
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    _prepare,
    build_frozen_plan,
    rasterize,
    rasterize_partition,
    stack_plans,
)
from opengaussian_tpu_torch.train.loop import Trainer
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)  # the repo's image tolerance
T_EPS_TOL = 2e-4  # a window's local early stop: at most T_EPS per pixel
P_FIXED = 65536
JDEEP = jrast.RasterizeConfig(backend="xla", max_per_tile=768, chunk=32,
                              min_intersections=65536)
JWIN = jrast.RasterizeConfig(backend="pallas", max_per_tile=64, chunk=32,
                             min_intersections=65536, tile_windows=12)
DEEP = RasterizeConfig(max_per_tile=768, chunk=32, min_intersections=65536)
WIN = RasterizeConfig(max_per_tile=64, chunk=32, min_intersections=65536, tile_windows=12)
FIELDS = ("means", "sh_dc", "sh_rest", "logit_opacity", "log_scales", "quats", "ins_feat",
          "alive")


def deep_scene(n=500, seed=0):
    """tests/test_windows.py:deep_scene: most splats on a few tiles, so the
    deepest tiles hold ~n/4 slots; translucent, so the blend reaches deep."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(0, 0.08, n), rng.normal(0, 0.06, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.05, 0.6, n).astype(np.float32)
    pay = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, scales, quats, op, pay


def sparse_scene(n=256, seed=1):
    """tests/test_rasterize.py:random_scene."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(scale=0.6, size=n), rng.normal(scale=0.6, size=n),
                      rng.uniform(2.0, 6.0, size=n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.1, 0.95, size=n).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return means, scales, quats, op, cols


def cams(w, h):
    return (JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h),
            Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h))


def both_cov(scales, quats):
    jc = jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    return jc, torch.as_tensor(np.asarray(jc))


def t(x):
    return torch.as_tensor(np.asarray(x))


def test_windowed_bins_and_render_match_jax():
    """At one fixed budget the port's windows are the JAX package's: the
    virtual tiles' maps, counts, starts and the drop and truncation counts
    equal; the windowed image, alpha and depth within the image tolerance of
    the JAX package's windowed render (its Pallas kernels in interpret
    mode), the gradients within 1e-3 normalised."""
    means, scales, quats, op, pay = deep_scene(n=300, seed=2)
    jc, tc = cams(64, 48)
    jcov, tcov = both_cov(scales, quats)
    jcfg = dataclasses.replace(JWIN, intersection_budget=P_FIXED)
    cfg = dataclasses.replace(WIN, intersection_budget=P_FIXED)
    pj = jproj.project(jnp.asarray(means), jcov, jc, opacities=jnp.asarray(op))
    a = jbin.bin_gaussians(pj, 4, 3, P_FIXED, 64, dense=False, stream=True,
                           window_depth=12)
    _, b, _ = _prepare(tc, t(means), tcov, t(op), cfg)
    assert b.counts.shape[0] > 12 and int(b.vt_n.max()) > 1  # deep tiles split
    for f in ("vt_real", "vt_first", "vt_n", "counts", "tile_start", "n_dropped",
              "n_truncated"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)
    tgt = np.random.default_rng(1).uniform(size=(48, 64, 3)).astype(np.float32)
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)

    def jloss(m, o, p):
        r = jrast.rasterize(jc, m, jcov, o, p, jnp.asarray(bg), jcfg)
        return jnp.sum(jnp.abs(r.image - tgt)) + jnp.sum(r.alpha), r

    (_, jr), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(means), jnp.asarray(op), jnp.asarray(pay))
    leaves = [t(x).requires_grad_(True) for x in (means, op, pay)]
    r = rasterize(tc, *leaves[:1], tcov, leaves[1], leaves[2], t(bg), cfg)
    loss = (r.image - t(tgt)).abs().sum() + r.alpha.sum()
    g = torch.autograd.grad(loss, leaves)
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(r, k).detach().numpy(), np.asarray(getattr(jr, k)),
                                   **TOL, err_msg=k)
    assert int(r.n_truncated) == int(jr.n_truncated) == 0
    for name, x, y in zip(("means", "opacities", "payload"), g, jg):
        assert_normalised(x.numpy(), y, 1e-3, name)


def test_windowed_matches_deep():
    """tests/test_windows.py:46: the windowed render of the deep scene
    within the T_EPS bound of the deep unwindowed one, the port's and the
    JAX package's (XLA scan), with nothing dropped or truncated."""
    means, scales, quats, op, pay = deep_scene()
    jc, tc = cams(96, 64)
    jcov, tcov = both_cov(scales, quats)
    bg = np.asarray([0.2, 0.1, 0.4], np.float32)
    ref = jrast.rasterize(jc, jnp.asarray(means), jcov, jnp.asarray(op), jnp.asarray(pay),
                          jnp.asarray(bg), JDEEP)
    deep = rasterize(tc, t(means), tcov, t(op), t(pay), t(bg), DEEP)
    out = rasterize(tc, t(means), tcov, t(op), t(pay), t(bg), WIN)
    assert int(ref.n_truncated) == int(deep.n_truncated) == 0
    assert int(out.n_truncated) == 0 and int(out.n_dropped) == 0
    for want in (deep, ref):
        np.testing.assert_allclose(out.image.numpy(), np.asarray(want.image),
                                   atol=T_EPS_TOL, rtol=1e-4)
        np.testing.assert_allclose(out.alpha.numpy(), np.asarray(want.alpha), atol=T_EPS_TOL)
        np.testing.assert_allclose(out.depth.numpy(), np.asarray(want.depth),
                                   atol=6e-4, rtol=1e-3)


def test_windowed_sparse_scene_unchanged():
    """tests/test_windows.py:74: a scene with no deep tile gives one window
    per tile and the unwindowed image to 1e-6."""
    means, scales, quats, op, cols = sparse_scene()
    _, tc = cams(80, 64)
    _, tcov = both_cov(scales, quats)
    cfg = dataclasses.replace(WIN, max_per_tile=256, tile_windows=4)
    a = rasterize(tc, t(means), tcov, t(op), t(cols), torch.zeros(3), cfg)
    b = rasterize(tc, t(means), tcov, t(op), t(cols), torch.zeros(3),
                  dataclasses.replace(cfg, tile_windows=0))
    np.testing.assert_allclose(a.image.numpy(), b.image.numpy(), atol=1e-6)
    np.testing.assert_allclose(a.alpha.numpy(), b.alpha.numpy(), atol=1e-6)


def test_windowed_gradients_match_deep():
    """tests/test_windows.py:92: loss and gradients through the fold within
    the windows' bound (2e-3 normalised) of the deep unwindowed render's,
    the port's and the JAX package's."""
    means, scales, quats, op, pay = deep_scene(n=300, seed=2)
    jc, tc = cams(64, 48)
    jcov, tcov = both_cov(scales, quats)
    tgt = np.random.default_rng(1).uniform(size=(48, 64, 3)).astype(np.float32)

    def tloss(cfg):
        leaves = [t(x).requires_grad_(True) for x in (means, op, pay)]
        r = rasterize(tc, leaves[0], tcov, leaves[1], leaves[2], torch.zeros(3), cfg)
        loss = (r.image - t(tgt)).abs().sum() + r.alpha.sum()
        return float(loss), torch.autograd.grad(loss, leaves)

    def jloss(inputs):
        m, o, p = inputs
        r = jrast.rasterize(jc, m, jcov, o, p, jnp.zeros(3), JDEEP)
        return jnp.sum(jnp.abs(r.image - tgt)) + jnp.sum(r.alpha)

    lw, gw = tloss(WIN)
    ld, gd = tloss(DEEP)
    lj, gj = jax.value_and_grad(jloss)(tuple(jnp.asarray(x) for x in (means, op, pay)))
    for want_l, want_g in ((ld, gd), (float(lj), gj)):
        np.testing.assert_allclose(lw, want_l, rtol=1e-3)
        for name, a, b in zip(("means", "opacities", "payload"), gw, want_g):
            assert_normalised(a.numpy(), np.asarray(b), 2e-3, name)


def test_window_truncation_counted():
    """tests/test_windows.py:117: too few windows show in n_truncated, the
    JAX package's count at the same budget."""
    means, scales, quats, op, pay = deep_scene()
    jc, tc = cams(96, 64)
    jcov, tcov = both_cov(scales, quats)
    cfg = dataclasses.replace(WIN, tile_windows=2, intersection_budget=P_FIXED)
    out = rasterize(tc, t(means), tcov, t(op), t(pay), torch.zeros(3), cfg)
    pj = jproj.project(jnp.asarray(means), jcov, jc, opacities=jnp.asarray(op))
    a = jbin.bin_gaussians(pj, 6, 4, P_FIXED, 64, dense=False, stream=True, window_depth=2)
    assert int(out.n_truncated) == int(a.n_truncated) > 0


def _deep_states(n=800, seed=3):
    means, scales, quats, op, pay = deep_scene(n=n, seed=seed)
    st = jcreate(means, pay, capacity=n, seed=0)
    st = dataclasses.replace(st, log_scales=jnp.log(jnp.asarray(scales)),
                             quats=jnp.asarray(quats),
                             logit_opacity=jnp.log(jnp.asarray(op)) - jnp.log1p(-jnp.asarray(op)))
    tst = TG.state_from_numpy({k: np.asarray(getattr(st, k)) for k in FIELDS}, device="cpu")
    return st, tst, pay


def test_tuner_window_branch_matches_jax(monkeypatch):
    """tests/test_windows.py:128 under the opt-in: with a base config that
    sets tile_windows, tuned_config caps K at WINDOW_K and sizes the windows
    and window_extra as the JAX package's tuned_config does (WINDOW_K 128 in
    both), and the tuned render loses nothing; windowed_variant at two
    depths equals the JAX package's. Without tile_windows in the base, K
    grows past WINDOW_K and no window is used."""
    monkeypatch.setattr(jbudget, "WINDOW_K", 128)
    monkeypatch.setattr(budget, "WINDOW_K", 128)
    jst, tst, pay = _deep_states()
    jc, tc = cams(96, 64)
    jbase = jrast.RasterizeConfig(backend="pallas", max_per_tile=2048, chunk=32,
                                  min_intersections=65536)
    base = RasterizeConfig(max_per_tile=2048, chunk=32, min_intersections=65536,
                           tile_windows=1)
    jt = jbudget.tuned_config(jbase, jst, [jc])
    tt = budget.tuned_config(base, tst, [tc])
    assert jt.max_per_tile == 128 and jt.tile_windows >= 2
    for f in ("max_per_tile", "tile_windows", "window_extra", "intersection_budget"):
        assert getattr(tt, f) == getattr(jt, f), f
    assert budget.probe.last_window_extras == jbudget.probe.last_window_extras
    for k in (256, 128):
        jv, tv = jbudget.windowed_variant(jt, k), budget.windowed_variant(tt, k)
        assert (tv.max_per_tile, tv.tile_windows, tv.window_extra) == (
            jv.max_per_tile, jv.tile_windows, jv.window_extra), k
    cov = build_cov3d(tst.scales, tst.quats)
    out = rasterize(tc, tst.means, cov, tst.opacity, t(pay), torch.zeros(3), tt)
    assert int(out.n_truncated) == 0 and int(out.n_dropped) == 0
    plain = budget.tuned_config(dataclasses.replace(base, tile_windows=0), tst, [tc])
    assert plain.tile_windows == 0 and plain.max_per_tile > 128


def test_trainer_fit_grows_windows_not_k():
    """Without fixed budgets the trainer's K fit keeps max_per_tile under
    tile windows and raises the window count to cover 1.3x the deepest
    tile; without windows it raises max_per_tile."""
    _, tst, _ = _deep_states()
    _, tc = cams(96, 64)
    bundle = types.SimpleNamespace(num_views=1, camera=lambda i: tc)
    tr = types.SimpleNamespace(bundle=bundle, state=tst,
                               rcfg=dataclasses.replace(WIN, tile_windows=1))
    Trainer._fit_max_per_tile(tr)
    k = -(-int(_deepest(tst, tc) * 1.3) // 32) * 32
    assert tr.rcfg.max_per_tile == 64 and tr.rcfg.tile_windows == -(-k // 64) >= 2
    tr.rcfg = dataclasses.replace(WIN, tile_windows=0)
    Trainer._fit_max_per_tile(tr)
    assert (tr.rcfg.tile_windows, tr.rcfg.max_per_tile) == (0, k)


def _deepest(st, cam):
    from opengaussian_tpu_torch.ops.rasterize import deepest_tile

    return deepest_tile(cam, st.means, build_cov3d(st.scales, st.quats), st.opacity, DEEP)


def test_windowed_partition_matches_jax():
    """rasterize_partition under tile windows (each (group, tile)'s windows
    folded, pixels of tile vt % T) against the JAX package's windowed
    partition render, and within the T_EPS bound of the port's unwindowed
    one."""
    means, scales, quats, op, pay = deep_scene(n=400, seed=5)
    jc, tc = cams(64, 48)
    jcov, tcov = both_cov(scales, quats)
    group = (np.arange(400) % 3).astype(np.int32)
    jcfg = dataclasses.replace(JWIN, tile_windows=8, intersection_budget=P_FIXED)
    cfg = dataclasses.replace(WIN, tile_windows=8, intersection_budget=P_FIXED)
    jr = jrast.rasterize_partition(jc, jnp.asarray(means), jcov, jnp.asarray(op),
                                   jnp.asarray(group), 3, jnp.asarray(pay), jnp.zeros(3), jcfg)
    r = rasterize_partition(tc, t(means), tcov, t(op), t(group), 3, t(pay), torch.zeros(3),
                            cfg)
    u = rasterize_partition(tc, t(means), tcov, t(op), t(group), 3, t(pay), torch.zeros(3),
                            dataclasses.replace(cfg, tile_windows=0, max_per_tile=512))
    assert int(r.n_truncated) == int(jr.n_truncated) == 0
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(r, k).numpy(), np.asarray(getattr(jr, k)), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(r.image.numpy(), u.image.numpy(), atol=T_EPS_TOL, rtol=1e-4)


def test_windowed_frozen_plan_matches_fresh():
    """A windowed FrozenPlan carries the virtual tiles' maps of the fresh
    binning, and renders and differentiates as the fresh binning does;
    stacked with a view of another virtual-tile count (dead windows pad
    it), each view renders as through its own plan."""
    means, scales, quats, op, pay = deep_scene(n=400, seed=6)
    _, tc = cams(64, 48)
    _, tcov = both_cov(scales, quats)
    args = (t(means), tcov, t(op))
    plan = build_frozen_plan(tc, *args, WIN)
    _, bins, _ = _prepare(tc, *args, WIN)
    for f, g in (("g_sorted", "sorted_gauss"), ("tstart", "tile_start"), ("counts", "counts"),
                 ("vt_real", "vt_real"), ("vt_first", "vt_first"), ("vt_n", "vt_n")):
        assert torch.equal(getattr(plan, f), getattr(bins, g)), f

    def run(cam, frozen):
        p = t(pay).requires_grad_(True)
        r = rasterize(cam, *args, p, torch.zeros(3), WIN, frozen=frozen)
        return r.image, torch.autograd.grad((r.image ** 2).sum() + r.alpha.sum(), [p])[0]

    img0, g0 = run(tc, None)
    img1, g1 = run(tc, plan)
    assert torch.equal(img0, img1) and torch.equal(g0, g1)
    cam2 = Camera.from_fov(np.eye(3), np.asarray([0.3, 0, 0], np.float32), 0.9, 0.7, 64, 48)
    plan2 = build_frozen_plan(cam2, *args, WIN)
    assert plan2.counts.shape != plan.counts.shape  # the per-frame P moves Tv
    st = stack_plans([plan, plan2], len(means))
    for i, (cam, own) in enumerate(((tc, plan), (cam2, plan2))):
        a = rasterize(cam, *args, t(pay), torch.zeros(3), WIN, frozen=st.select(i))
        b = rasterize(cam, *args, t(pay), torch.zeros(3), WIN, frozen=own)
        assert torch.equal(a.image, b.image)


@pytest.mark.parametrize("field", ["tile_windows", "window_extra", "band_intersection_budget"])
def test_config_rejects_negative_window_fields(field):
    with pytest.raises(ValueError, match=field):
        RasterizeConfig(**{field: -1})
