"""The port's optimizer (models/optimizer.py) and densification
(models/gaussians.py) against the JAX package's, on seeded numpy inputs.

densify_and_prune draws the split children's offsets inside the JAX
function (jax.random.normal(key, (2, cap, 3))); the test makes the same
draws from the same key and hands them to the port, so both see the same
numbers and nothing in the JAX package changes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.models import optimizer as jopt
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.models import optimizer as topt

torch.set_num_threads(1)

FIELDS = JG.PARAM_FIELDS


def toy_state(n=40, cap=256, seed=0):
    """tests/test_model.py:toy_state, in the JAX package."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.uniform(2.5, 5, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return JG.create_from_pcd(pts, cols, sh_degree=3, seed=seed, capacity=cap)


def to_port(st):
    d = {k: np.asarray(getattr(st, k)) for k in FIELDS + ("alive",)}
    return TG.state_from_numpy(d, device="cpu")


def np_tree(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_tree(got: dict, want: dict, name: str, atol=1e-3):
    """Normalised comparison of every leaf: |got - want| / max|want| <= atol."""
    for k in FIELDS:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, atol=atol,
                                   err_msg=f"{name}[{k}]")


def test_adam_three_steps_match_jax():
    rng = np.random.default_rng(0)
    st = toy_state(30, cap=64)
    jp = st.params()
    tp = to_port(st).params()
    ja, ta = jopt.init(jp), topt.init(tp)
    lrs = jopt.learning_rates(JOpt(), 7, 2.5)
    tlrs = topt.learning_rates(TOpt(), 7, 2.5)
    for _ in range(3):
        g = {k: rng.normal(0, 1e-2, np.shape(v)).astype(np.float32) for k, v in jp.items()}
        jp, ja = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, ja, lrs)
        tp, ta = topt.apply(tp, {k: torch.as_tensor(v) for k, v in g.items()}, ta, tlrs)
    assert ta.count == int(ja.count) == 3
    assert_tree(tp, jp, "params", atol=1e-6)
    assert_tree(ta.mu, ja.mu, "mu", atol=1e-6)
    assert_tree(ta.nu, ja.nu, "nu", atol=1e-6)


@pytest.mark.parametrize("it", [0, 1000, 30_000])
def test_learning_rates_match_jax(it):
    cfg = dict(frozen_init_pts=False)
    want = jopt.learning_rates(JOpt(**cfg), it, 3.7)
    got = topt.learning_rates(TOpt(**cfg), it, 3.7)
    assert set(got) == set(want) == set(FIELDS)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6, err_msg=k)
    got_s = topt.learning_rates(TOpt(start_ins_feat_iter=0), it + 1, 3.7)
    assert got_s["means"] == got_s["sh_dc"] == 0.0  # geometry frozen past stage 0


def clone_split_setup():
    """tests/test_model.py:test_densify_clone_and_split: 5 splits, 5 clones."""
    st = toy_state(40, cap=256)
    mu = jax.tree.map(jnp.ones_like, st.params())
    nu = jax.tree.map(lambda x: 2.0 * jnp.ones_like(x), st.params())
    stats = JG.DensifyStats.zeros(256)
    stats = dataclasses.replace(stats, grad_accum=jnp.zeros(256).at[:10].set(1.0),
                                denom=jnp.ones(256))
    logs = st.log_scales.at[:5].set(jnp.log(2.0)).at[5:10].set(jnp.log(1e-4))
    return dataclasses.replace(st, log_scales=logs), mu, nu, stats, dict(
        max_grad=0.5, min_opacity=0.005, extent=3.0, max_screen_size=0.0,
        percent_dense=0.01)


def prune_setup():
    """tests/test_model.py:test_densify_prune_low_opacity, plus the
    world-size prune (max_screen_size set)."""
    st = toy_state(40, cap=128)
    lo = st.logit_opacity.at[:7].set(JG.inverse_sigmoid(jnp.float32(0.001)))
    ls = st.log_scales.at[10:13].set(jnp.log(1.0))
    z = jax.tree.map(jnp.zeros_like, st.params())
    return (dataclasses.replace(st, logit_opacity=lo, log_scales=ls), z, z,
            JG.DensifyStats.zeros(128), dict(max_grad=1e9, min_opacity=0.005,
                                             extent=3.0, max_screen_size=20.0,
                                             percent_dense=0.01))


def overflow_setup():
    """Every alive splat hot in a nearly full capacity: children overflow."""
    st = toy_state(120, cap=128)
    z = jax.tree.map(jnp.zeros_like, st.params())
    stats = dataclasses.replace(JG.DensifyStats.zeros(128), grad_accum=jnp.ones(128),
                                denom=jnp.ones(128))
    return st, z, z, stats, dict(max_grad=0.5, min_opacity=0.005, extent=3.0,
                                 max_screen_size=0.0, percent_dense=0.01)


@pytest.mark.parametrize("setup", [clone_split_setup, prune_setup, overflow_setup])
def test_densify_and_prune_matches_jax(setup):
    st, mu, nu, stats, kw = setup()
    key = jax.random.PRNGKey(3)
    j_st, (j_mu, j_nu), j_stats, j_over = JG.densify_and_prune(st, (mu, nu), stats, key, **kw)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (2, st.capacity, 3))))
    t_mu = TG.adam_from_numpy(np_tree(mu), np_tree(nu), 0, device="cpu")
    t_stats = TG.stats_from_numpy(stats.grad_accum, stats.denom, stats.max_radii2d,
                                  device="cpu")
    t_st, (tm, tn), t_stats2, t_over = TG.densify_and_prune(
        to_port(st), (t_mu.mu, t_mu.nu), t_stats, noise=noise, **kw)
    assert torch.equal(t_st.alive, torch.as_tensor(np.asarray(j_st.alive)))
    assert int(t_over) == int(j_over)
    assert_tree(t_st.params(), j_st.params(), "params", atol=1e-6)
    assert_tree(tm, j_mu, "mu", atol=0)
    assert_tree(tn, j_nu, "nu", atol=0)
    assert float(t_stats2.grad_accum.abs().sum()) == 0.0
    if setup is overflow_setup:
        assert int(t_over) > 0


def test_densify_draws_from_a_generator():
    st, mu, nu, stats, kw = clone_split_setup()
    t_mu = TG.adam_from_numpy(np_tree(mu), np_tree(nu), 0, device="cpu")
    t_stats = TG.stats_from_numpy(stats.grad_accum, stats.denom, stats.max_radii2d,
                                  device="cpu")
    outs = [TG.densify_and_prune(to_port(st), (t_mu.mu, t_mu.nu), t_stats,
                                 generator=torch.Generator().manual_seed(s), **kw)[0]
            for s in (1, 1, 2)]
    assert torch.equal(outs[0].means, outs[1].means)
    assert not torch.equal(outs[0].means, outs[2].means)
    with pytest.raises(ValueError, match="noise or a generator"):
        TG.densify_and_prune(to_port(st), (t_mu.mu, t_mu.nu), t_stats, **kw)


def test_reset_opacity_matches_jax():
    st = toy_state(20, cap=128)
    mu = jax.tree.map(jnp.ones_like, st.params())
    j_st, (j_mu, _) = JG.reset_opacity(st, (mu, mu))
    t = TG.adam_from_numpy(np_tree(mu), np_tree(mu), 0, device="cpu")
    t_st, (t_mu, _) = TG.reset_opacity(to_port(st), (t.mu, t.nu))
    np.testing.assert_allclose(t_st.logit_opacity.numpy(), np.asarray(j_st.logit_opacity),
                               rtol=1e-6)
    assert_tree(t_mu, j_mu, "mu", atol=0)


def test_stats_update_and_grow_match_jax():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(64, 2)).astype(np.float32)
    radii = rng.integers(0, 3, 64).astype(np.int32)
    want = JG.DensifyStats.zeros(64).update(jnp.asarray(g), jnp.asarray(radii))
    got = TG.DensifyStats.zeros(64, "cpu").update(torch.as_tensor(g), torch.as_tensor(radii))
    for f in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6)
    st = toy_state(20, cap=64)
    grown_j, grown_t = JG.grow_capacity(st, 128), TG.grow_capacity(to_port(st), 128)
    for k in FIELDS + ("alive",):
        np.testing.assert_array_equal(getattr(grown_t, k).numpy(),
                                      np.asarray(getattr(grown_j, k)))
    assert TG.grow_capacity(got, 128).denom.shape == (128,)
