"""The port's feature-stage modules against the JAX package: SAM masks,
the stage-1 losses and their gradients, the root k-means, the
straight-through quantizer and sweep 1 of the pseudo labels.

The same numpy inputs go through both packages. The k-means++ seeds come
from each package's own generator, which cannot agree (ROADMAP Queue 3,
RNG), so the tests hand both the same initial centers: the port through
`assign_root(..., init_centers=...)`, the JAX package by replacing its
`init_centers_from_points` for the call.

Traps to rule out before filing a mismatch as a fault:
  * TF32: every product here is float32 at PyTorch's default precision.
  * Argmin ties: the fixtures' clusters are well separated.
  * Sort stability: the separation loss ranks with a stable argsort, as
    jnp.argsort does; ties among padded entries keep their order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops import kmeans as jkm
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import losses as jlosses
from opengaussian_tpu.train import pseudo as jpseudo
from opengaussian_tpu.utils import masks as jmasks
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import kmeans as tkm
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import losses as tlosses
from opengaussian_tpu_torch.train import pseudo as tpseudo
from opengaussian_tpu_torch.utils import masks as tmasks
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

FIELDS = JG.PARAM_FIELDS


def mask_case(seed, n_masks=7, max_masks=16, H=24, W=32, C=6):
    """A feature image and SAM ids 0..n_masks (0 = no mask)."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(0, 1, (H, W, C)).astype(np.float32)
    ids = rng.integers(0, n_masks + 1, (H, W)).astype(np.int32)
    sil = rng.uniform(size=(H, W)) > 0.3
    return feat, ids, sil, max_masks


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_match_jax(seed):
    feat, ids, sil, M = mask_case(seed)
    j_masks, j_valid = jmasks.masks_onehot(jnp.asarray(ids), M)
    t_masks, t_valid = tmasks.masks_onehot(torch.as_tensor(ids), M)
    np.testing.assert_array_equal(t_masks.numpy(), np.asarray(j_masks))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    for image_mask in (None, sil):
        want = jmasks.mask_feature_mean(jnp.asarray(feat), j_masks, image_mask=(
            None if image_mask is None else jnp.asarray(image_mask)), return_var=True)
        got = tmasks.mask_feature_mean(torch.as_tensor(feat), t_masks, image_mask=(
            None if image_mask is None else torch.as_tensor(image_mask)), return_var=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5, rtol=1e-4)
    other = np.random.default_rng(seed + 9).uniform(size=ids.shape) > 0.5
    for base in ("union", "former", "later"):
        np.testing.assert_allclose(
            tmasks.calculate_iou(t_masks, torch.as_tensor(other)[None], base).numpy(),
            np.asarray(jmasks.calculate_iou(j_masks, jnp.asarray(other)[None], base)),
            rtol=1e-6)


@pytest.mark.parametrize("seed,n_masks,iteration", [(0, 7, 1000), (1, 12, 40_000),
                                                    (2, 2, 100)])
def test_stage1_losses_and_grads_match_jax(seed, n_masks, iteration):
    """cohesion + separation on silhouette-masked means, and the gradient of
    their weighted sum by the feature image (through the means too)."""
    feat, ids, sil, M = mask_case(seed, n_masks)

    def jloss(f):
        masks, valid = jmasks.masks_onehot(jnp.asarray(ids), M)
        means = jmasks.mask_feature_mean(f, masks, image_mask=jnp.asarray(sil))
        coh = jlosses.cohesion_loss(f, masks, valid, means)
        sep = jlosses.separation_loss(means, valid, jnp.int32(iteration))
        return sep + 0.1 * coh, (coh, sep)

    (j_total, (j_coh, j_sep)), j_grad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(feat))
    f = torch.tensor(feat, requires_grad=True)
    masks, valid = tmasks.masks_onehot(torch.as_tensor(ids), M)
    means = tmasks.mask_feature_mean(f, masks, image_mask=torch.as_tensor(sil))
    coh = tlosses.cohesion_loss(f, masks, valid, means)
    sep = tlosses.separation_loss(means, valid, iteration)
    total = sep + 0.1 * coh
    (grad,) = torch.autograd.grad(total, f)
    for g, w in ((coh, j_coh), (sep, j_sep), (total, j_total)):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=2e-5)
    assert_normalised(grad.numpy(), j_grad, 1e-3, "d feat")


def test_cohesion_grad_finite_at_zero_distance():
    """A pixel exactly at its mask's mean (and empty masks) must give a zero,
    not a NaN, gradient: the double where."""
    feat = np.zeros((4, 4, 6), np.float32)
    ids = np.ones((4, 4), np.int32)
    f = torch.tensor(feat, requires_grad=True)
    masks, valid = tmasks.masks_onehot(torch.as_tensor(ids), 8)
    means = tmasks.mask_feature_mean(f, masks)
    (g,) = torch.autograd.grad(tlosses.cohesion_loss(f, masks, valid, means), f)
    assert torch.isfinite(g).all() and not g.any()


def clustered(n=400, k=5, seed=0):
    """Features of n splats around k well-separated centers (6-D feature +
    3-D position), an alive mask with a few dead (NaN) rows."""
    rng = np.random.default_rng(seed)
    cen = rng.normal(0, 3, (k, 9)).astype(np.float32)
    lab = rng.integers(0, k, n)
    x = (cen[lab] + rng.normal(0, 0.2, (n, 9))).astype(np.float32)
    alive = np.ones(n, bool)
    alive[-7:] = False
    x[-7:] = np.nan  # densification surgery leaves NaN in dead rows
    return x[:, :6], x[:, 6:], alive


def test_lloyd_and_match_labels_match_jax():
    feat, xyz, alive = clustered()
    x = np.where(alive[:, None], np.concatenate([feat, xyz], 1), 0.0).astype(np.float32)
    w = alive.astype(np.float32)
    c0 = x[np.random.default_rng(1).choice(np.flatnonzero(alive), 5, replace=False)]
    jc, ji = jkm._lloyd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(c0), 5)
    tc, ti = tkm._lloyd(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(c0), 5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32

    ref = np.asarray(jc)[[3, 0, 4, 1, 2]] + 0.05
    jp, jinv = jkm.match_labels(jc, jnp.asarray(ref))
    tp, tinv = tkm.match_labels(tc, torch.as_tensor(ref))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tp.numpy(), [1, 3, 4, 0, 2])


def test_assign_root_matches_jax(monkeypatch):
    """The first assignment (init) and a reassignment from the cached
    centers, both from the same injected k-means++ seeds."""
    k = 5
    feat, xyz, alive = clustered(seed=2)
    rng = np.random.default_rng(3)
    live = np.flatnonzero(alive)
    seeds = [np.concatenate([feat, xyz], 1)[rng.choice(live, k, replace=False)]
             for _ in range(2)]
    j_state = jkm.KMeansState.create(len(alive), k, 3)
    t_state = tkm.KMeansState.create(len(alive), k, 3, device="cpu")
    for init, s in zip((True, False), seeds):
        monkeypatch.setattr(jkm, "init_centers_from_points",
                            lambda *a, s=s: jnp.asarray(s, jnp.float32))
        j_state = jkm.assign_root(j_state, jnp.asarray(feat), jnp.asarray(xyz),
                                  jnp.asarray(alive), 0.5, jax.random.PRNGKey(0),
                                  init=init)
        t_state = tkm.assign_root(t_state, torch.as_tensor(feat), torch.as_tensor(xyz),
                                  torch.as_tensor(alive), 0.5, init=init,
                                  init_centers=torch.as_tensor(s, dtype=torch.float32))
        np.testing.assert_allclose(t_state.centers.numpy(), np.asarray(j_state.centers),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(t_state.cls_ids.numpy(), np.asarray(j_state.cls_ids))
        assert np.isfinite(t_state.centers.numpy()).all()
        feat = feat + 0.05  # the features drift between reassignments
    assert 0 <= int(t_state.cls_ids.min()) and int(t_state.cls_ids.max()) < k


def test_kmeans_pp_draws_from_the_generator():
    """The port's own k-means++ seeds: k distinct alive points, the same for
    the same generator seed."""
    feat, xyz, alive = clustered(seed=4)
    x = torch.as_tensor(np.where(alive[:, None], np.concatenate([feat, xyz], 1), 0.0))
    w = torch.as_tensor(alive, dtype=torch.float32)
    a = tkm.init_centers_from_points(x, w, 5, torch.Generator().manual_seed(0))
    b = tkm.init_centers_from_points(x, w, 5, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and len(torch.unique(a, dim=0)) == 5
    assert all(bool((x[~torch.as_tensor(alive)] != c).any(1).all()) for c in a)


def test_quantize_matches_jax_with_straight_through_grad():
    rng = np.random.default_rng(5)
    n, k1, k2 = 50, 4, 3
    d = dict(centers=rng.normal(size=(k1, 9)), cls_ids=rng.integers(0, k1, n),
             leaf_centers=rng.normal(size=(k1 * k2 + 1, 6)),
             leaf_cls_ids=rng.integers(0, k1 * k2 + 1, n), leaf_sub_num=np.full(k1, k2))
    j_state = jkm.KMeansState(**{f: jnp.asarray(v, jnp.float32 if "centers" in f
                                                 else jnp.int32) for f, v in d.items()})
    t_state = tkm.kmeans_from_numpy(d, device="cpu")
    feat = rng.normal(size=(n, 6)).astype(np.float32)
    wts = rng.normal(size=(n, 6)).astype(np.float32)
    for mode in ("root", "leaf"):
        jq, jg = jax.value_and_grad(
            lambda f: jnp.sum(jkm.quantize(j_state, f, mode) ** 2 * wts))(jnp.asarray(feat))
        f = torch.tensor(feat, requires_grad=True)
        q = tkm.quantize(t_state, f, mode)
        (g,) = torch.autograd.grad((q ** 2 * torch.as_tensor(wts)).sum(), f)
        np.testing.assert_allclose(float((q.detach() ** 2 * torch.as_tensor(wts)).sum()),
                                   float(jq), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
        sampled = (d["centers"][d["cls_ids"], :6] if mode == "root"
                   else d["leaf_centers"][d["leaf_cls_ids"]])
        np.testing.assert_allclose(q.detach().numpy(), sampled, rtol=1e-6, atol=1e-6)


def test_kmeans_state_grows_like_jax():
    t = tkm.KMeansState.create(8, 4, 5, device="cpu")
    t = tkm.kmeans_from_numpy(dict(centers=t.centers, cls_ids=np.arange(8) % 4,
                                   leaf_centers=t.leaf_centers, leaf_cls_ids=np.arange(8),
                                   leaf_sub_num=t.leaf_sub_num), device="cpu").grow(12)
    np.testing.assert_array_equal(t.cls_ids.numpy(), [0, 1, 2, 3] * 2 + [0] * 4)
    np.testing.assert_array_equal(t.leaf_cls_ids.numpy(), list(range(8)) + [20] * 4)


def test_sweep1_math_matches_jax():
    """Mask means and the variance filter: the fixture holds a high-variance
    mask that is dropped and a dominant high-variance mask that is kept."""
    rng = np.random.default_rng(6)
    H, W, M = 24, 32, 8
    ids = np.zeros((H, W), np.int32)
    ids[:, :20] = 1  # dominant
    ids[:8, 20:] = 2
    ids[8:16, 20:] = 3
    ids[16:, 20:26] = 4
    feat = np.full((H, W, 6), 0.5, np.float32) + rng.normal(0, 0.01, (H, W, 6)).astype(
        np.float32)
    feat[:, :20] += rng.normal(0, 0.3, (H, 20, 6)).astype(np.float32)  # noisy, dominant
    feat[:8, 20:] += rng.normal(0, 0.3, (8, 12, 6)).astype(np.float32)  # noisy: dropped
    jp, jm = jpseudo.sweep1_math(jnp.asarray(feat), jnp.asarray(ids), M)
    tp, tm = tpseudo.sweep1_math(torch.as_tensor(feat), torch.as_tensor(ids), M)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=3e-5, rtol=1e-4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert set(np.unique(tm.numpy())) == {0, 1, 3, 4}


def test_construct_pseudo_labels_matches_jax():
    """Sweep 1 over three views of a small scene: the rendered feature
    images' mask means, per view."""
    rng = np.random.default_rng(7)
    n, cap = 150, 256
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.uniform(2.5, 5, n)], -1).astype(np.float32)
    state = JG.create_from_pcd(pts, rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                               capacity=cap)
    t_state = TG.state_from_numpy({k: np.asarray(getattr(state, k))
                                   for k in FIELDS + ("alive",)}, device="cpu")
    W_, H_ = 48, 40
    poses = [(np.eye(3), np.array([dx, 0.0, 0.0], np.float32)) for dx in (-0.2, 0.0, 0.2)]
    jcams = [JCamera.from_fov(R, t, 0.9, 0.7, W_, H_) for R, t in poses]
    tcams = [tcam.Camera.from_fov(R, t, 0.9, 0.7, W_, H_) for R, t in poses]
    ids = np.stack([(np.arange(W_)[None, :] // 12 + 4 * (np.arange(H_)[:, None] // 20)
                     + 1 + v) % 9 for v in range(3)]).astype(np.int32)
    jcfg = JRaster(max_per_tile=256, chunk=32, min_intersections=16384, backend="pallas")
    want = jpseudo.construct_pseudo_labels(state, jcams, jnp.asarray(ids), jnp.zeros(3),
                                           16, jcfg)
    for layout in ("stream", "dense"):
        got = tpseudo.construct_pseudo_labels(
            t_state, tcams, torch.as_tensor(ids), torch.zeros(3), 16,
            TRaster(max_per_tile=256, chunk=32, pallas_input=layout))
        assert got.feat.shape == (3, H_, W_, 6)
        np.testing.assert_allclose(got.feat.numpy(), np.asarray(want.feat), atol=3e-5,
                                   rtol=1e-4)
        np.testing.assert_array_equal(got.mask_ids.numpy(), np.asarray(want.mask_ids))
    assert float(np.abs(np.asarray(want.feat)).max()) > 0
    with pytest.raises(NotImplementedError):
        tpseudo.construct_pseudo_labels(t_state, tcams, torch.as_tensor(ids),
                                        torch.zeros(3), 16, TRaster(), mode="leaf")
