"""The port's group renders against the JAX package's: partition binning
(ops/binning.py with group_of), rasterize_scan_groups with its gradients,
rasterize_partition, and the cluster renders of render/__init__.py.

The JAX scan runs its XLA blend (backend="xla"); its partition render needs
the Pallas stream kernels, run in interpret mode (backend="pallas"). Budgets
drop and truncate nothing. The port runs its kernels' plain versions.

Traps to rule out before filing a mismatch as a fault:
  * Depth ties: the fixtures use well-separated depths (see
    tests/test_torch_binning.py).
  * Stream length: the JAX stream has the fixed budget P, the port's the
    frame's exact total, so only each virtual tile's run is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops import binning as jbin
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import rasterize as jras
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.render import render_clusters as j_render_clusters
from opengaussian_tpu.render import render_clusters_partition as j_render_partition
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import binning as tbin
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    rasterize_partition,
    rasterize_scan_groups,
)
from opengaussian_tpu_torch.render import render_clusters, render_clusters_partition
from tests.test_rasterize import make_cam
from tests.test_torch_binning import separated_scene
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

W, H = 64, 48
GX, GY = (W + 15) // 16, (H + 15) // 16
TOL = dict(atol=3e-5, rtol=1e-4)
XLA = JConfig(max_per_tile=256, chunk=32, min_intersections=16384, backend="xla")
PALLAS = JConfig(max_per_tile=256, chunk=32, min_intersections=16384, backend="pallas")
TCFG = RasterizeConfig(max_per_tile=256, chunk=32)


def tcamera():
    return tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H)


def scene(n=240, seed=0, groups=3):
    """Separated depths, 5 payload channels and a group per splat (one
    group left empty when groups > 3)."""
    means, scales, quats, op = separated_scene(n, seed)
    rng = np.random.default_rng(seed + 10)
    cols = rng.uniform(size=(n, 5)).astype(np.float32)
    group_of = rng.integers(0, min(groups, 3), n).astype(np.int32)
    return means, scales, quats, op, cols, group_of


def test_partition_binning_matches_jax():
    """counts and tile_start over G x T virtual tiles and every virtual
    tile's run, with the depth rank computed once outside."""
    means, scales, quats, op, _, group_of = scene(groups=4)
    G = 4
    cov = np.array(jproj.build_cov3d(scales, quats))
    pj = jproj.project(means, cov, make_cam(W, H), opacities=op)
    a = jbin.bin_gaussians(pj, GX, GY, 16384, 256, dense=False, stream=True,
                           group_of=jnp.asarray(group_of), num_groups=G)
    pt = tproj.project(*map(torch.as_tensor, (means, cov)), tcamera(),
                       opacities=torch.as_tensor(op))
    rank = tbin.depth_rank(pt.depth)
    b = tbin.bin_gaussians(pt, GX, GY, 256, rank=rank, group_of=torch.as_tensor(group_of),
                           num_groups=G)
    counts, tstart = np.asarray(a.counts), np.asarray(a.tile_start)
    assert counts.shape == (G * GX * GY,)
    np.testing.assert_array_equal(b.counts.numpy(), counts)
    np.testing.assert_array_equal(b.tile_start.numpy(), tstart)
    sa, sb = np.asarray(a.sorted_gauss), b.sorted_gauss.numpy()
    for s, c in zip(tstart, counts):
        np.testing.assert_array_equal(sb[s:s + c], sa[s:s + c])
    assert int(a.n_dropped) == int(b.n_truncated) == 0
    assert counts[3 * GX * GY:].sum() == 0 and counts[:GX * GY].sum() > 0  # group 3 empty
    # each group's runs are that group's splats, as a one-group binning gives
    for g in range(G):
        vt = slice(g * GX * GY, (g + 1) * GX * GY)
        for s, c in zip(tstart[vt], counts[vt]):
            assert (group_of[sb[s:s + c]] == g).all()
    plain = tbin.bin_gaussians(pt, GX, GY, 256)
    assert torch.equal(plain.sorted_gauss, tbin.bin_gaussians(pt, GX, GY, 256, rank=rank)
                       .sorted_gauss)
    with pytest.raises(ValueError, match="stream-only"):
        tbin.bin_gaussians(pt, GX, GY, 256, dense=True, group_of=torch.as_tensor(group_of),
                           num_groups=G)


@pytest.mark.parametrize("G,layout", [(1, "stream"), (3, "stream"), (3, "dense")])
def test_scan_groups_match_jax(G, layout):
    """Images, alpha, depth, radii and the gradients by means, scales,
    quats, the per-group opacities and the payload."""
    means, scales, quats, op, cols, group_of = scene(groups=G)
    opg = np.stack([np.where(group_of == g, op, 0.0) for g in range(G)]).astype(np.float32)
    target = np.random.default_rng(3).uniform(size=(G, H, W, 5)).astype(np.float32)

    def jloss(m, s, q, o, c):
        r = jras.rasterize_scan_groups(make_cam(W, H), m, jproj.build_cov3d(s, q), o, c,
                                       jnp.zeros(5), XLA)
        return jnp.sum((r.image - target) ** 2) + 0.1 * jnp.sum(r.alpha * r.depth), r

    (jl, jr), jg = jax.jit(jax.value_and_grad(jloss, argnums=range(5), has_aux=True))(
        *map(jnp.asarray, (means, scales, quats, opg, cols)))
    leaves = [torch.tensor(x, requires_grad=True) for x in (means, scales, quats, opg, cols)]
    m, s, q, o, c = leaves
    r = rasterize_scan_groups(tcamera(), m, tproj.build_cov3d(s, q), o, c, torch.zeros(5),
                              RasterizeConfig(max_per_tile=256, chunk=32,
                                              pallas_input=layout))
    assert r.image.shape == (G, H, W, 5) and r.alpha.shape == (G, H, W)
    for name in ("image", "alpha", "depth"):
        np.testing.assert_allclose(getattr(r, name).detach().numpy(),
                                   np.asarray(getattr(jr, name)), **TOL, err_msg=name)
    np.testing.assert_array_equal(r.radii.numpy(), np.asarray(jr.radii))
    assert int(r.n_truncated) == int(jr.n_truncated) == 0
    loss = ((r.image - torch.as_tensor(target)) ** 2).sum() + 0.1 * (r.alpha * r.depth).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for name, got, want in zip(("means", "scales", "quats", "opacities", "payload"),
                               torch.autograd.grad(loss, leaves), jg):
        assert_normalised(got.numpy(), want, 1e-3, name)
    if G > 1:  # every group holds only its own splats
        for g in range(G):
            assert float(r.alpha[g].max()) > 0.5


def test_partition_matches_jax_and_scan():
    """One partition render of three groups against the JAX package's
    (Pallas, interpret mode) and against the port's own scan."""
    means, scales, quats, op, cols, group_of = scene()
    G = 3
    cov = np.array(jproj.build_cov3d(scales, quats))
    jr = jras.rasterize_partition(make_cam(W, H), jnp.asarray(means), jnp.asarray(cov),
                                  jnp.asarray(op), jnp.asarray(group_of), G,
                                  jnp.asarray(cols), jnp.zeros(5), PALLAS)
    args = [torch.as_tensor(x) for x in (means, cov, op)]
    r = rasterize_partition(tcamera(), *args, torch.as_tensor(group_of), G,
                            torch.as_tensor(cols), torch.zeros(5), TCFG)
    opg = torch.stack([torch.where(torch.as_tensor(group_of) == g, args[2], 0.0)
                       for g in range(G)])
    rs = rasterize_scan_groups(tcamera(), args[0], args[1], opg, torch.as_tensor(cols),
                               torch.zeros(5), TCFG)
    for name in ("image", "alpha", "depth"):
        got = getattr(r, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jr, name)), **TOL, err_msg=name)
        np.testing.assert_allclose(got, getattr(rs, name).numpy(), **TOL, err_msg=name)
    np.testing.assert_array_equal(r.radii.numpy(), np.asarray(jr.radii))
    with pytest.raises(ValueError, match="stream"):
        rasterize_partition(tcamera(), *args, torch.as_tensor(group_of), G,
                            torch.as_tensor(cols), torch.zeros(5),
                            RasterizeConfig(max_per_tile=256, chunk=32, pallas_input="dense"))


def cluster_state(n=300, cap=384, seed=4):
    """Two packages' copies of a state whose clusters cover the frame with
    opaque splats (silhouettes pass 0.8), with a cluster id per splat:
    roots 0-3, leaves root * 3 + 0..2."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.permutation(np.linspace(2.5, 5.0, n))], -1).astype(np.float32)
    state = JG.create_from_pcd(pts, rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                               capacity=cap)
    state = state.with_params({**state.params(),
                               "logit_opacity": jnp.where(state.alive, 2.0, -10.0),
                               "log_scales": state.log_scales + 0.7})
    t_state = TG.state_from_numpy({k: np.asarray(getattr(state, k))
                                   for k in JG.PARAM_FIELDS + ("alive",)}, device="cpu")
    leaf = rng.integers(0, 12, cap).astype(np.int32)
    return state, t_state, leaf


@pytest.mark.parametrize("better_vis", [False, True])
def test_render_clusters_match_jax(better_vis):
    """render_clusters (scan) and render_clusters_partition: images,
    silhouettes, occur and valid; a group id past every cluster is empty."""
    state, t_state, leaf = cluster_state()
    group_ids = np.array([3, 4, 5, 12], np.int32)
    kw = dict(origin_feat=True, better_vis=better_vis, scale_limit=0.1, min_points=20)
    jcam = make_cam(W, H)
    want = jax.jit(lambda st: j_render_clusters(jcam, st, jnp.zeros(3), jnp.asarray(leaf),
                                                jnp.asarray(group_ids), XLA, **kw))(state)
    want_p = j_render_partition(jcam, state, jnp.zeros(3), jnp.asarray(leaf),
                                jnp.asarray(group_ids), PALLAS, **kw)
    got = render_clusters(tcamera(), t_state, torch.zeros(3), torch.as_tensor(leaf),
                          torch.as_tensor(group_ids), TCFG, **kw)
    proj = tproj.project(t_state.means, tproj.build_cov3d(t_state.scales, t_state.quats),
                         tcamera(), opacities=t_state.opacity)
    got_p = render_clusters_partition(tcamera(), t_state, torch.zeros(3),
                                      torch.as_tensor(leaf), torch.as_tensor(group_ids),
                                      TCFG, proj=proj, rank=tbin.depth_rank(proj.depth),
                                      **kw)
    for g, w in ((got, want), (got_p, want_p), (got_p, want)):
        np.testing.assert_allclose(g.cluster_imgs.numpy(), np.asarray(w.cluster_imgs), **TOL)
        np.testing.assert_allclose(g.cluster_silhouettes.numpy(),
                                   np.asarray(w.cluster_silhouettes), **TOL)
        np.testing.assert_array_equal(g.cluster_occur.numpy(), np.asarray(w.cluster_occur))
        np.testing.assert_array_equal(g.cluster_valid.numpy(), np.asarray(w.cluster_valid))
    occur, valid = got.cluster_occur.numpy(), got.cluster_valid.numpy()
    assert not valid[3] and float(got.cluster_silhouettes[3].max()) == 0.0
    if not better_vis:  # the fixture exercises what it claims
        assert occur[:3].all()
