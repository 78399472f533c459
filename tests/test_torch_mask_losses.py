"""The stage-1 SAM-mask losses (train/losses.py:sam_mask_loss) and their
kernels (ops/mask_loss_kernels.py, csrc/mask_losses.cu): the plain path
against the JAX package's composition (masks_onehot, mask_feature_mean,
cohesion_loss, separation_loss), the kernels' plain versions (sums by id,
the analytic backward) through `MaskLoss` against the dense composition,
the CPU dispatch, and, on the card, the kernels against their plain
versions.

The module imports no JAX (the JAX reference is imported inside its
helper), so its card cases also run where JAX is absent:

    python -m pytest -q --noconftest -m gpu tests/test_torch_mask_losses.py
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.ops import mask_loss_kernels as mk
from opengaussian_tpu_torch.train import losses

torch.set_num_threads(1)

LOSS_WEIGHT = 0.1

# name -> (max_masks, H, W, C, iteration, what the case holds)
CASES = {
    "empty-masks": (8, 20, 24, 6, 1000, "ids 1..3 only: masks 4..8 have no pixel"),
    "id-zero": (8, 20, 24, 6, 1000, "a third of the pixels id 0, some past max_masks"),
    "zero-silhouette": (8, 16, 20, 6, 1000, "no pixel inside the silhouette"),
    "at-mean": (8, 16, 20, 6, 1000, "masks whose pixels sit exactly at their mean"),
    "early": (32, 24, 32, 6, 35_000, "the last iteration of the rank weighting"),
    "late": (32, 24, 32, 6, 35_001, "the hard-pair focus past 35,000"),
    "m8": (8, 20, 24, 3, 200, "eight masks, three channels"),
    "m32": (32, 32, 40, 6, 30_001, "the benchmark's mask count"),
    "m264": (264, 40, 50, 6, 40_000, "past one block's shared memory on the card"),
}


def make_case(name: str, seed: int = 0):
    """numpy feat [H, W, C], ids [H, W] int32, sil [H, W] float32 in {0, 1},
    max_masks and the iteration of CASES[name]."""
    M, H, W, C, iteration, _ = CASES[name]
    rng = np.random.default_rng(seed)
    feat = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
    sil = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    # blocks of ids, as SAM masks are regions, with scattered pixels
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    side = int(np.ceil(np.sqrt(M)))
    ids = 1 + (yy * side // H) * side + (xx * side // W)
    scatter = rng.uniform(size=(H, W)) < 0.1
    ids = np.where(scatter, rng.integers(1, M + 1, (H, W)), ids)
    ids = np.where(ids > M, 0, ids)
    if name == "empty-masks":
        ids = np.minimum(ids, 3)
    if name == "id-zero":
        ids = np.where(rng.uniform(size=(H, W)) < 0.33, 0, ids)
        ids[0, :5] = M + np.arange(1, 6)  # ids past max_masks are no mask
    if name == "zero-silhouette":
        sil[:] = 0.0
    if name == "at-mean":
        ids[ids == 1], ids[ids == 5] = 2, 6
        ids[:4, :4], feat[:4, :4], sil[:4, :4] = 1, 0.5, 1.0  # 16 pixels: mean 0.5 exactly
        ids[10, 10], sil[10, 10] = 5, 1.0  # one pixel: its own mean
    return feat, ids.astype(np.int32), sil, M, iteration


def assert_normalised(got, want, atol, name):
    """|got - want| within atol of want's largest magnitude, and finite."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), f"{name}: not finite"
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, err_msg=name)


def jax_losses(feat, ids, sil, M, iteration):
    """The JAX package's composition: -> (sep, loss_weight * coh, d feat of
    their sum), numpy."""
    import jax
    import jax.numpy as jnp

    from opengaussian_tpu.train import losses as jlosses
    from opengaussian_tpu.utils import masks as jmasks

    def loss(f):
        masks, valid = jmasks.masks_onehot(jnp.asarray(ids), M)
        means = jmasks.mask_feature_mean(f, masks, image_mask=jnp.asarray(sil))
        sep = jlosses.separation_loss(means, valid, jnp.int32(iteration))
        coh = LOSS_WEIGHT * jlosses.cohesion_loss(f, masks, valid, means)
        return sep + coh, (sep, coh)

    (_, (sep, coh)), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(feat))
    return float(sep), float(coh), np.asarray(grad)


def torch_losses(fn, feat, ids, sil, M, iteration):
    """fn(feat, ids, sil) -> (sep, weighted coh) on torch tensors: -> (sep,
    coh, d feat of their sum) as floats and numpy."""
    f = torch.tensor(feat, requires_grad=True)
    sep, coh = fn(f, torch.as_tensor(ids), torch.as_tensor(sil))
    (grad,) = torch.autograd.grad(sep + coh, f)
    return float(sep.detach()), float(coh.detach()), grad.numpy()


def by_id(f, ids, sil, M, iteration):
    """The kernels' plain versions through MaskLoss, then the separation
    loss on their means."""
    means, valid, coh = mk.MaskLoss.apply(f, ids, sil, M)
    return losses.separation_loss(means, valid, iteration), LOSS_WEIGHT * coh


def dense(f, ids, sil, M, iteration):
    return losses.sam_mask_loss_plain(f, ids, sil, M, iteration, LOSS_WEIGHT)


@pytest.mark.parametrize("name", list(CASES))
def test_sam_mask_loss_matches_jax(name):
    """sam_mask_loss on CPU tensors (the dense composition) against the JAX
    package's: both terms and the gradient by the feature image."""
    feat, ids, sil, M, it = make_case(name)
    got = torch_losses(lambda f, i, s: losses.sam_mask_loss(f, i, s, M, it, LOSS_WEIGHT),
                       feat, ids, sil, M, it)
    want = jax_losses(feat, ids, sil, M, it)
    np.testing.assert_allclose(got[:2], want[:2], rtol=2e-5, atol=1e-7)
    assert_normalised(got[2], want[2], 1e-3, f"{name}: d feat")


@pytest.mark.parametrize("name", list(CASES))
def test_sums_by_id_match_the_dense_composition(name):
    """The kernels' plain versions (sums by id forward, the analytic
    backward) through MaskLoss against the dense composition with autograd,
    and against the JAX package; the NaN trap gives a finite gradient."""
    feat, ids, sil, M, it = make_case(name)
    got = torch_losses(lambda f, i, s: by_id(f, i, s, M, it), feat, ids, sil, M, it)
    want = torch_losses(lambda f, i, s: dense(f, i, s, M, it), feat, ids, sil, M, it)
    np.testing.assert_allclose(got[:2], want[:2], rtol=2e-6, atol=1e-8)
    assert_normalised(got[2], want[2], 1e-5, f"{name}: d feat, by id against dense")
    j = jax_losses(feat, ids, sil, M, it)
    np.testing.assert_allclose(got[:2], j[:2], rtol=2e-5, atol=1e-7)
    assert_normalised(got[2], j[2], 1e-3, f"{name}: d feat, by id against JAX")


@pytest.mark.parametrize("name", ["id-zero", "at-mean", "m264"])
def test_plain_tables_hold_the_masks_sums(name):
    """mask_loss_fwd_plain's tables: counts and validity those of the mask
    stack, the weighted sums and means those of mask_feature_mean, the
    distance sums those of the dense distances."""
    from opengaussian_tpu_torch.utils import masks as masku

    feat, ids, sil, M, _ = make_case(name)
    f, i, s = torch.as_tensor(feat), torch.as_tensor(ids), torch.as_tensor(sil)
    means, valid, coh, tables = mk.mask_loss_fwd_plain(f, i, s, M)
    stats, dist, n_valid = mk.split_tables(tables, M, f.shape[2])
    masks, want_valid = masku.masks_onehot(i, M)
    m = masks.to(torch.float32)
    assert torch.equal(valid, want_valid)
    assert torch.equal(stats[:, 0], m.sum(dim=(1, 2)))
    assert float(n_valid) == float(want_valid.sum())
    torch.testing.assert_close(stats[:, 1], (m * s).sum(dim=(1, 2)), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(means, masku.mask_feature_mean(f, masks, image_mask=s),
                               rtol=1e-5, atol=1e-6)
    diff = f[None] - means[:, None, None, :]
    sq = (diff * diff).sum(-1)
    d = torch.where(sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0) * m
    torch.testing.assert_close(dist[:, 0], d.sum(dim=(1, 2)), rtol=1e-5, atol=1e-5)
    want_coh = losses.cohesion_loss(f, masks, want_valid, means)
    torch.testing.assert_close(coh, want_coh, rtol=1e-6, atol=1e-8)


def test_cpu_calls_run_the_plain_code():
    """CPU tensors never reach the kernels: the wrappers return their plain
    versions' results and count no launch; sam_mask_loss on the CPU is the
    dense composition."""
    feat, ids, sil, M, it = make_case("m32")
    f, i, s = torch.as_tensor(feat), torch.as_tensor(ids), torch.as_tensor(sil)
    before = {w: w.launches for w in mk.KERNEL_WRAPPERS}
    got = mk.mask_loss_fwd(f, i, s, M)
    want = mk.mask_loss_fwd_plain(f, i, s, M)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    d_coh, d_means = torch.tensor(0.7), torch.randn(M, f.shape[2])
    assert torch.equal(mk.mask_loss_bwd(f, i, s, got[0], got[3], d_coh, d_means),
                       mk.mask_loss_bwd_plain(f, i, s, got[0], got[3], d_coh, d_means))
    for a, b in zip(losses.sam_mask_loss(f, i, s, M, it, LOSS_WEIGHT),
                    losses.sam_mask_loss_plain(f, i, s, M, it, LOSS_WEIGHT)):
        assert torch.equal(a, b)
    assert {w: w.launches for w in mk.KERNEL_WRAPPERS} == before


def test_strided_feature_image():
    """A cropped view of a larger image (the rasterizer's crop of its tile
    grid) gives what its contiguous copy gives."""
    feat, ids, sil, M, _ = make_case("m32")
    big = torch.zeros((feat.shape[0] + 5, feat.shape[1] + 7, feat.shape[2]))
    big[:feat.shape[0], :feat.shape[1]] = torch.as_tensor(feat)
    view = big[:feat.shape[0], :feat.shape[1]]
    i, s = torch.as_tensor(ids), torch.as_tensor(sil)
    for a, b in zip(mk.mask_loss_fwd(view, i, s, M), mk.mask_loss_fwd(view.contiguous(), i, s, M)):
        assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f, i, s = torch.zeros((4, 5, 6)), torch.zeros((4, 5), dtype=torch.int32), torch.zeros((4, 5))
    with pytest.raises(ValueError, match="1 <= C <= 16"):
        mk.mask_loss_fwd(torch.zeros((4, 5, 17)), i, s, 8)
    with pytest.raises(ValueError, match="float32"):
        mk.mask_loss_fwd(f.double(), i, s, 8)
    with pytest.raises(ValueError, match="must be feat's"):
        mk.mask_loss_fwd(f, i[:3], s, 8)
    with pytest.raises(ValueError, match="at least 1"):
        mk.mask_loss_fwd(f, i, s, 0)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mk.mask_loss_fwd(f.to("meta"), i.to("meta"), s.to("meta"), 8)


# --------------------------------------------------------------------------
# on the card: the kernels against their plain versions


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def bench_frame(M: int, dev, seed: int = 0):
    """A 730x985 frame of the benchmark's stage-1 cell: features in [0, 1]
    read through a crop of a larger tile grid, SAM-like blocks of ids (0 in
    an 8-row border, 1..M, some past M), the silhouette > 0.7 of a smooth
    field."""
    H, W, C = 730, 985, 6
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.rand((736, 992, C), generator=g, device=dev)
    feat = grid[:H, :W]
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    side = int(np.ceil(np.sqrt(M)))
    ids = (1 + (yy * side // H) * side + (xx * side // W)).to(torch.int32)
    ids[:8] = 0
    alpha = 0.5 + 0.5 * torch.sin(yy / 37.0) * torch.cos(xx / 53.0)
    sil = (alpha > 0.7).to(torch.float32)
    return feat, ids, sil


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [32, 264])
def test_kernels_match_plain_on_the_card(cuda, M):
    """Forward tables, means, validity and the cohesion loss, and the
    backward, against the plain versions on the card (the sums run in
    another order: fp32 rounding); two runs bit for bit; one launch each."""
    feat, ids, sil = bench_frame(M, cuda)
    before = {w: w.launches for w in mk.KERNEL_WRAPPERS}
    got = mk.mask_loss_fwd(feat, ids, sil, M)
    again = mk.mask_loss_fwd(feat, ids, sil, M)
    want = mk.mask_loss_fwd_plain(feat, ids, sil.contiguous(), M)
    torch.cuda.synchronize()
    assert mk.mask_loss_fwd.launches == before[mk.mask_loss_fwd] + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    means, valid, coh, tables = got
    assert torch.equal(valid, want[1])
    stats, dist, n_valid = mk.split_tables(tables, M, 6)
    w_stats, w_dist, w_n = mk.split_tables(want[3], M, 6)
    assert torch.equal(stats[:, 0], w_stats[:, 0]) and torch.equal(n_valid, w_n)
    for name, a, b in (("means", means, want[0]), ("stats", stats, w_stats),
                       ("dist", dist, w_dist), ("coh", coh, want[2])):
        assert rel_err(a, b) < 1e-5, name
    g = torch.Generator(device=cuda).manual_seed(1)
    d_coh = torch.rand((), generator=g, device=cuda)
    d_means = torch.randn((M, 6), generator=g, device=cuda)
    d = mk.mask_loss_bwd(feat, ids, sil, means, tables, d_coh, d_means)
    d2 = mk.mask_loss_bwd(feat, ids, sil, means, tables, d_coh, d_means)
    d_plain = mk.mask_loss_bwd_plain(feat, ids, sil, want[0], want[3], d_coh, d_means)
    torch.cuda.synchronize()
    assert mk.mask_loss_bwd.launches == before[mk.mask_loss_bwd] + 2
    assert torch.equal(d, d2)
    assert rel_err(d, d_plain) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("iteration", [30_001, 40_000])
def test_sam_mask_loss_on_the_card_matches_the_dense_composition(cuda, iteration):
    """sam_mask_loss through the kernels against the dense composition on
    the card, both terms and the gradient by the (cropped) feature image."""
    feat, ids, sil = bench_frame(32, cuda)
    out = []
    for fn in (losses.sam_mask_loss, losses.sam_mask_loss_plain):
        f = feat.detach().requires_grad_(True)
        sep, coh = fn(f[:, :], ids, sil, 32, iteration, LOSS_WEIGHT)
        (grad,) = torch.autograd.grad(sep + coh, f)
        out.append((sep.detach(), coh.detach(), grad))
    (sep, coh, grad), (w_sep, w_coh, w_grad) = out
    torch.testing.assert_close(sep, w_sep, rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(coh, w_coh, rtol=1e-5, atol=1e-8)
    assert rel_err(grad, w_grad) < 1e-4
