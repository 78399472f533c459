"""The port's checkpoints (train/checkpoint.py) against the JAX package's:
a round trip bit for bit, .npz interop in both directions, `load_torch` of
reference `chkpnt*.pth` files in the 14- and the legacy 12-tuple forms, and
--checkpoint_iterations / --start_checkpoint through cli.train.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.models import optimizer as jopt
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.train import checkpoint as jckpt
from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import checkpoint as tckpt
from tests.test_data import make_colmap_scene
from tests.test_torch_train import FIELDS

torch.set_num_threads(1)


def port_training_state(seed=0, cap=256, k1=4, k2=3):
    """A port state, Adam state, densify stats and k-means state with
    seeded, non-trivial values in every field."""
    rng = np.random.default_rng(seed)
    n = 200
    state = TG.create_from_pcd(rng.normal(0, 1, (n, 3)).astype(np.float32),
                               rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=cap,
                               device="cpu")
    r = lambda *s: torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))  # noqa: E731
    mu = {k: r(*v.shape) for k, v in state.params().items()}
    nu = {k: r(*v.shape).abs() for k, v in state.params().items()}
    adam = TG.AdamState(mu=mu, nu=nu, count=17)
    stats = TG.DensifyStats(r(cap).abs(), r(cap).abs(), r(cap).abs())
    kms = tkm.KMeansState(
        centers=r(k1, 9), cls_ids=torch.as_tensor(rng.integers(0, k1, cap), dtype=torch.int32),
        leaf_centers=r(k1 * k2 + 1, 6),
        leaf_cls_ids=torch.as_tensor(rng.integers(0, k1 * k2 + 1, cap), dtype=torch.int32),
        leaf_sub_num=torch.as_tensor([3, 2, 3, 1], dtype=torch.int32))
    return state, adam, stats, kms


def assert_same(a, b):
    """Two (state, adam, stats, kms, iteration) tuples, bit for bit; either
    may hold JAX or torch arrays."""
    to_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    (sa, aa, ta, ka, ia), (sb, ab, tb, kb, ib) = a, b
    assert ia == ib
    for k in FIELDS + ("alive",):
        x, y = to_np(getattr(sa, k)), to_np(getattr(sb, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in FIELDS:
        np.testing.assert_array_equal(to_np(aa.mu[k]), to_np(ab.mu[k]), err_msg=k)
        np.testing.assert_array_equal(to_np(aa.nu[k]), to_np(ab.nu[k]), err_msg=k)
    assert int(aa.count) == int(ab.count)
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(to_np(getattr(ta, k)), to_np(getattr(tb, k)), err_msg=k)
    for k in ("centers", "cls_ids", "leaf_centers", "leaf_cls_ids", "leaf_sub_num"):
        x, y = to_np(getattr(ka, k)), to_np(getattr(kb, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_round_trip_is_bit_exact(tmp_path):
    state, adam, stats, kms = port_training_state()
    path = str(tmp_path / "sub" / "chkpnt42.npz")
    tckpt.save(path, state, adam, stats, kms, 42)
    got = tckpt.load(path, device="cpu")
    assert_same((state, adam, stats, kms, 42), got)
    assert isinstance(got[1].count, int) and got[0].alive.dtype == torch.bool
    tckpt.save(path, state, adam, stats, None, 43)
    assert tckpt.load(path, device="cpu")[3] is None


def test_npz_interop_both_ways(tmp_path):
    """A port-written checkpoint loads in the JAX package's load, and a
    JAX-written one in the port's, with the same flat keys."""
    state, adam, stats, kms = port_training_state(seed=1)
    port_path = str(tmp_path / "port.npz")
    tckpt.save(port_path, state, adam, stats, kms, 7)
    assert_same((state, adam, stats, kms, 7), jckpt.load(port_path))

    rng = np.random.default_rng(2)
    js = JG.create_from_pcd(rng.normal(0, 1, (100, 3)).astype(np.float32),
                            rng.uniform(0, 1, (100, 3)).astype(np.float32), capacity=128)
    ja = jopt.init(js.params())
    ja = ja._replace(mu={k: v + 0.5 for k, v in ja.mu.items()}, count=jnp.int32(9))
    jt = JG.DensifyStats.zeros(128)
    jk = jkm.KMeansState.create(128, 4, 3)._replace(
        cls_ids=jnp.asarray(rng.integers(0, 4, 128), jnp.int32))
    jax_path = str(tmp_path / "jax.npz")
    jckpt.save(jax_path, js, ja, jt, jk, 3000)
    assert sorted(np.load(jax_path).files) == sorted(np.load(port_path).files)
    assert_same((js, ja, jt, jk, 3000), tckpt.load(jax_path, device="cpu"))


def _make_capture(n, rng, with_ins_feat=True, with_opt_state=True):
    """A reference capture() tuple with its optimizer (a copy of
    tests/test_torch_ckpt.py:_make_capture)."""
    xyz = torch.tensor(rng.normal(0, 1, (n, 3)).astype(np.float32))
    f_dc = torch.tensor(rng.normal(0, 1, (n, 1, 3)).astype(np.float32))
    f_rest = torch.tensor(rng.normal(0, 0.1, (n, 15, 3)).astype(np.float32))
    scaling = torch.tensor(rng.normal(-3, 1, (n, 3)).astype(np.float32))
    rotation = torch.tensor(rng.normal(0, 1, (n, 4)).astype(np.float32))
    opacity = torch.tensor(rng.normal(0, 1, (n, 1)).astype(np.float32))
    max_radii = torch.tensor(rng.uniform(0, 50, (n,)).astype(np.float32))
    grad_accum = torch.tensor(rng.uniform(0, 1, (n, 1)).astype(np.float32))
    denom = torch.tensor(rng.uniform(0, 9, (n, 1)).astype(np.float32))

    params = [xyz, f_dc, f_rest, opacity, scaling, rotation]
    names = ["xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"]
    if with_ins_feat:
        ins_feat = torch.tensor(rng.uniform(0, 1, (n, 6)).astype(np.float32))
        params.append(ins_feat)
        names.append("ins_feat")
    for p in params:
        p.requires_grad_(True)

    opt = torch.optim.Adam(
        [{"params": [p], "lr": 0.001, "name": nm} for p, nm in zip(params, names)],
        lr=0.0, eps=1e-15,
    )
    if with_opt_state:
        loss = sum((p**2).mean() for p in params)
        loss.backward()
        opt.step()

    if with_ins_feat:
        return (3, xyz, f_dc, f_rest, scaling, rotation, opacity,
                ins_feat, torch.empty(0), max_radii, grad_accum, denom,
                opt.state_dict(), 4.5)
    return (3, xyz, f_dc, f_rest, scaling, rotation, opacity,
            max_radii, grad_accum, denom, opt.state_dict(), 4.5)


@pytest.mark.parametrize("with_ins_feat", [True, False])
def test_load_torch_matches_jax(tmp_path, with_ins_feat):
    """Both tuple forms: every field, moment and statistic as the JAX
    package loads them; the legacy form gets the same fresh features and a
    reset optimizer."""
    n = 100
    tup = _make_capture(n, np.random.default_rng(3), with_ins_feat=with_ins_feat)
    path = str(tmp_path / "chkpnt30000.pth")
    torch.save((tup, 30000), path)
    j_state, j_adam, j_stats, j_it, j_scale = jckpt.load_torch(path)
    got = tckpt.load_torch(path, device="cpu")
    assert got[3:] == (j_it, j_scale) == (30000, 4.5)
    t_state, t_adam, t_stats = got[:3]
    for k in FIELDS + ("alive",):
        np.testing.assert_array_equal(getattr(t_state, k).numpy(),
                                      np.asarray(getattr(j_state, k)), err_msg=k)
    for k in FIELDS:
        np.testing.assert_array_equal(t_adam.mu[k].numpy(), np.asarray(j_adam.mu[k]))
        np.testing.assert_array_equal(t_adam.nu[k].numpy(), np.asarray(j_adam.nu[k]))
    assert t_adam.count == int(j_adam.count) == (1 if with_ins_feat else 0)
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(t_stats, k).numpy(),
                                      np.asarray(getattr(j_stats, k)), err_msg=k)
    assert int(t_state.num_alive) == n and t_state.capacity == 4096
    # ensure_ins_feat keeps real features and fills all-zero ones as JAX does
    assert tckpt.ensure_ins_feat(t_state) is t_state
    zero = TG.GaussianState(**{**{k: getattr(t_state, k) for k in FIELDS + ("alive",)},
                               "ins_feat": torch.zeros_like(t_state.ins_feat)})
    np.testing.assert_array_equal(
        tckpt.ensure_ins_feat(zero, seed=5).ins_feat.numpy(),
        np.asarray(jckpt.ensure_ins_feat(JG.GaussianState(
            **{**{k: np.asarray(getattr(j_state, k)) for k in FIELDS + ("alive",)},
               "ins_feat": jnp.zeros(j_state.ins_feat.shape)}), seed=5).ins_feat))


def test_cli_checkpoints_and_resume(tmp_path):
    """--checkpoint_iterations 3 writes chkpnt3.npz; --start_checkpoint
    resumes there and runs iterations 4-5 (from a fresh view order: neither
    package checkpoints its random generators)."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3, with_sidecars=False)
    rcfg = TRaster(max_per_tile=1024, chunk=32)
    common = ["-s", root, "--iterations", "5", "--densify_from_iter", "1",
              "--densification_interval", "2", "--densify_grad_threshold", "1e-6"]
    full = tcli_train.main([*common, "-m", str(tmp_path / "a"), "--checkpoint_iterations",
                            "3"], device="cpu", rcfg=rcfg)
    path = str(tmp_path / "a" / "chkpnt3.npz")
    assert os.path.exists(path)
    state, _adam, _stats, kms, it = tckpt.load(path, device="cpu")
    assert it == 3 and kms is not None and state.capacity == full.state.capacity
    resumed = tcli_train.main([*common, "-m", str(tmp_path / "b"), "--start_checkpoint", path],
                              device="cpu", rcfg=rcfg)
    assert resumed.iteration == 5 and len(resumed.losses) == 2
    assert bool(torch.isfinite(torch.stack(resumed.losses)).all())
    assert os.path.exists(str(tmp_path / "b" / "point_cloud/iteration_5/point_cloud.ply"))
