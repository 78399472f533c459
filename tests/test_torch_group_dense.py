"""Dense group renders (group_render="dense"): the port's rasterize_groups,
GroupDenseBlend and the group entries of K5 and K6, against the JAX
package's rasterize_groups (its XLA path, the vmapped dense blend) and the
port's own scan of per-group renders (tests/test_scan_groups.py's bounds).

The group entries run their plain versions here: each is K5's or K6's plain
version once per group, on the block whose opacity column is that group's,
which the kernels reproduce bit for bit on the card (tests/test_torch_gpu.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu.ops.projection import build_cov3d as jcov
from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.models.gaussians import create_from_pcd
from opengaussian_tpu_torch.ops import rasterize_kernels as rk
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize_groups,
    rasterize_scan_groups,
)
from opengaussian_tpu_torch.render import render_clusters
from tests.test_torch_gpu import CHUNK, GRID_X, dense_starts, make_dense
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

CFG = RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=16384)
TOL = dict(atol=3e-5, rtol=1e-4)


def scene(n=300, g=3, seed=0, channels=6):
    """tests/test_scan_groups.py's scene: x-quantile groups and some splats
    in no group, as numpy arrays."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(scale=0.6, size=n), rng.normal(scale=0.5, size=n),
                      rng.uniform(2.0, 6.0, size=n)], axis=-1).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.1, 0.95, size=n).astype(np.float32)
    pay = rng.uniform(size=(n, channels)).astype(np.float32)
    order = np.argsort(means[:, 0])
    gid = np.empty(n, np.int32)
    gid[order] = (np.arange(n) * g) // n
    gid[rng.uniform(size=n) < 0.1] = -1
    opac_g = np.where(gid[None, :] == np.arange(g)[:, None], op[None, :], 0.0)
    return means, scales, quats, pay, opac_g.astype(np.float32)


def cams(w, h):
    return (JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h),
            Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, w, h))


@pytest.mark.parametrize("tight", [True, False])
def test_groups_forward_matches_jax(tight):
    means, scales, quats, pay, opac_g = scene(n=300, g=4)
    bg = np.asarray([0.2, 0.4, 0.1, 0.0, 0.7, 0.3], np.float32)
    jc, tc = cams(64, 48)
    jcfg = jrast.RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=16384,
                                 backend="xla", tight_radius=tight)
    cov = np.asarray(jcov(jnp.asarray(scales), jnp.asarray(quats)))
    a = jrast.rasterize_groups(jc, jnp.asarray(means), jnp.asarray(cov),
                               jnp.asarray(opac_g), jnp.asarray(pay), jnp.asarray(bg), jcfg)
    cfg = dataclasses.replace(CFG, tight_radius=tight)
    b = rasterize_groups(tc, torch.as_tensor(means), torch.as_tensor(cov),
                         torch.as_tensor(opac_g), torch.as_tensor(pay), torch.as_tensor(bg),
                         cfg)
    np.testing.assert_allclose(b.image.numpy(), np.asarray(a.image), **TOL)
    np.testing.assert_allclose(b.alpha.numpy(), np.asarray(a.alpha), atol=3e-5)
    np.testing.assert_allclose(b.depth.numpy(), np.asarray(a.depth), atol=3e-4, rtol=1e-4)
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    assert int(b.n_dropped) == int(a.n_dropped) == 0
    assert int(b.n_truncated) == int(a.n_truncated) == 0


def _group_loss(render_fn, c, cov, bg, tgt):
    def loss(m, o, p):
        r = render_fn(c, m, cov, o, p, bg)
        img = torch.cat([r.image, r.alpha[..., None]], dim=-1)
        return (img - tgt).abs().sum()
    return loss


def test_groups_gradients_match_jax_and_scan():
    """Gradients by the means, the per-group opacities and the payload: the
    port's dense groups against the JAX package's (XLA) and the port's scan,
    to 2e-5 normalised (tests/test_scan_groups.py:90's bound)."""
    means, scales, quats, pay, opac_g = scene(n=300, g=3)
    bg = np.full(6, 0.1, np.float32)
    jc, tc = cams(64, 48)
    tgt = np.random.default_rng(7).uniform(size=(3, 48, 64, 7)).astype(np.float32)
    cov = np.asarray(jcov(jnp.asarray(scales), jnp.asarray(quats)))
    jcfg = jrast.RasterizeConfig(max_per_tile=256, chunk=32, min_intersections=16384,
                                 backend="xla")

    def jloss(m, o, p):
        r = jrast.rasterize_groups(jc, m, jnp.asarray(cov), o, p, jnp.asarray(bg), jcfg)
        img = jnp.concatenate([r.image, r.alpha[..., None]], axis=-1)
        return jnp.sum(jnp.abs(img - jnp.asarray(tgt)))

    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(means), jnp.asarray(opac_g), jnp.asarray(pay))
    tcov, ttgt, tbg = torch.as_tensor(cov), torch.as_tensor(tgt), torch.as_tensor(bg)
    grads = {}
    for name, fn in (("dense", rasterize_groups), ("scan", rasterize_scan_groups)):
        inputs = [torch.as_tensor(x).requires_grad_(True) for x in (means, opac_g, pay)]
        loss = _group_loss(lambda *a: fn(*a, CFG), tc, tcov, tbg, ttgt)(*inputs)
        grads[name] = (float(loss.detach()), torch.autograd.grad(loss, inputs))
    np.testing.assert_allclose(grads["dense"][0], float(lj), rtol=1e-5)
    np.testing.assert_allclose(grads["dense"][0], grads["scan"][0], rtol=1e-5)
    for i, name in enumerate(("means", "opac", "payload")):
        d = grads["dense"][1][i].numpy()
        for want in (np.asarray(gj[i]), grads["scan"][1][i].numpy()):
            sc = float(np.abs(want).max()) or 1.0
            np.testing.assert_allclose(d / sc, want / sc, atol=2e-5, err_msg=name)


def test_render_clusters_dense_matches_scan():
    """render_clusters under group_render="dense" and "scan": images,
    silhouettes, occur and valid (tests/test_scan_groups.py:122)."""
    rng = np.random.default_rng(3)
    n = 500
    pts = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.5, n),
                    rng.uniform(2, 6, n)], -1).astype(np.float32)
    st = create_from_pcd(pts, rng.uniform(0, 1, (n, 3)).astype(np.float32), capacity=n,
                         seed=0, device="cpu")
    cls = torch.as_tensor((np.argsort(np.argsort(pts[:, 0])) * 4) // n, dtype=torch.int32)
    big = dataclasses.replace(CFG, max_per_tile=1024, chunk=64, min_intersections=65536)
    _, c = cams(96, 64)
    outs = [render_clusters(c, st, torch.zeros(3), cls, [0, 1, 2, 3],
                            dataclasses.replace(big, group_render=mode), min_points=1)
            for mode in ("scan", "dense")]
    np.testing.assert_allclose(outs[1].cluster_imgs.numpy(), outs[0].cluster_imgs.numpy(),
                               **TOL)
    np.testing.assert_allclose(outs[1].cluster_silhouettes.numpy(),
                               outs[0].cluster_silhouettes.numpy(), atol=3e-5)
    assert torch.equal(outs[1].cluster_occur, outs[0].cluster_occur)
    assert torch.equal(outs[1].cluster_valid, outs[0].cluster_valid)
    assert int(outs[1].n_lost) == int(outs[0].n_lost) == 0


def test_group_dense_under_a_fixed_budget():
    """The union binning at a fixed budget: slots past the last tile carry
    id n, which the group backward's ids (g n + id) must drop rather than
    send into the next group's splat 0. Image and gradients equal the
    per-frame stream's."""
    means, scales, quats, pay, opac_g = scene(n=300, g=3, seed=2)
    _, c = cams(64, 48)
    cov = build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    bg = torch.full((6,), 0.1)
    fixed = dataclasses.replace(CFG, intersection_budget=20000, min_intersections=8192)
    res = []
    for cfg in (CFG, fixed):
        o = torch.as_tensor(opac_g).requires_grad_(True)
        p = torch.as_tensor(pay).requires_grad_(True)
        r = rasterize_groups(c, torch.as_tensor(means), cov, o, p, bg, cfg)
        loss = (r.image * torch.linspace(0, 1, r.image.numel()).reshape(r.image.shape)).sum()
        res.append((r, torch.autograd.grad(loss, [o, p])))
    assert int(res[1][0].n_dropped) == 0
    assert torch.equal(res[1][0].image, res[0][0].image)
    for a, b, name in zip(res[1][1], res[0][1], ("opac", "payload")):
        assert_normalised(a, b, 1e-5, name)


@pytest.mark.parametrize("G", [1, 3])
def test_group_plain_versions_are_k5_k6_per_group(G):
    """blend_tiles_fwd_groups_plain / blend_tiles_bwd_groups_plain equal K5's
    and K6's plain versions run once per group on the block with that
    group's opacity column, bit for bit; the wrappers dispatch CPU tensors
    to them."""
    gdata, counts, stream = make_dense(seed=3, C=7)
    rows, tstart = stream[0], dense_starts(stream)
    T, K, F = gdata.shape
    rng = np.random.default_rng(5)
    n = 97
    gauss_idx = rng.integers(0, n, size=(T, K)).astype(np.int32)
    opac_g = np.where(rng.uniform(size=(G, n)) < 0.3, 0.0,
                      rng.uniform(0.05, 0.99, size=(G, n))).astype(np.float32)
    g, c, gi, og = map(torch.as_tensor, (gdata, counts, gauss_idx, opac_g))
    acc, tf = rk.blend_tiles_fwd_groups(g, gi, og, c, GRID_X, CHUNK)
    assert acc.shape == (G, T, F - 6, 256) and tf.shape == (G, T, 256)
    cot = [torch.as_tensor(rng.normal(0, 0.1, x.shape).astype(np.float32))
           for x in (acc, tf)]
    ts = torch.as_tensor(tstart)
    P = rows.shape[0]
    d = rk.blend_tiles_bwd_groups(g, gi, og, c, ts, P, acc, tf, *cot, GRID_X, CHUNK)
    assert d.shape == (G, P, F)
    for k in range(G):
        block = g.clone()
        block[..., 5] = og[k][gi.long()]
        a1, t1 = rk.blend_tiles_fwd_plain(block, c, GRID_X, CHUNK)
        assert torch.equal(acc[k], a1) and torch.equal(tf[k], t1)
        d1 = rk.blend_tiles_bwd_plain(block, c, ts, P, a1, t1, cot[0][k], cot[1][k],
                                      GRID_X, CHUNK)
        assert torch.equal(d[k], d1)
    assert rk.blend_tiles_fwd_groups.launches == rk.blend_tiles_bwd_groups.launches == 0
