"""Tile bands: the port's clip_rect_rows, banded bin_gaussians,
rasterize_banded and the probe's _band_totals against the JAX package
(ops/projection.py:207, ops/binning.py, ops/rasterize.py:612,
ops/budget.py:_band_totals; tests/test_rasterize.py:184,
tests/test_banded.py and tests/test_fuzz_configs.py:73) on the CPU.

The JAX package's banded render runs its XLA scan (backend "xla"), which its
own tests hold to its Pallas kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import binning as jbin
from opengaussian_tpu.ops import budget as jbudget
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu_torch.ops import binning as tbin
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize, rasterize_banded
from tests.test_torch_rasterize_grad import assert_normalised
from tests.test_torch_windows import both_cov, cams, sparse_scene, t

torch.set_num_threads(1)

LAYOUTS = {"stream": {}, "dense": {"pallas_input": "dense"},
           "compact": {"bwd_layout": "compact"}}


def _projections(w=96, h=80, n=200, seed=9):
    means, scales, quats, op, _ = sparse_scene(n, seed)
    jc, tc = cams(w, h)
    jcov, tcov = both_cov(scales, quats)
    pj = jproj.project(jnp.asarray(means), jcov, jc, opacities=jnp.asarray(op))
    pt = tproj.project(t(means), tcov, tc, opacities=t(op))
    return pj, pt


@pytest.mark.parametrize("rows", [(0, 2), (1, 4), (3, 5), (4, 9)])
def test_clip_rect_rows_matches_jax(rows):
    pj, pt = _projections()
    a, b = jproj.clip_rect_rows(pj, *rows), tproj.clip_rect_rows(pt, *rows)
    for f in ("rect_min", "rect_max", "num_tiles"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)
    assert torch.equal(b.valid, pt.valid) and torch.equal(b.mean2d, pt.mean2d)


@pytest.mark.parametrize("band", [dict(tile_lo=6, tile_hi=18), dict(tile_lo=24, band_size=12),
                                  dict(tile_lo=18, band_size=16)])
@pytest.mark.parametrize("dense", [False, True])
def test_banded_bins_match_jax(band, dense):
    """The band's counts, tile runs, dense matrix and truncation equal the
    JAX package's, at a fixed budget and a cap that truncates the middle
    rows; a band reaching past the 30 real tiles counts 0 there, the culled
    slots' run at id 30 left out (binning.py:281)."""
    pj, pt = _projections()
    P, K = 4096, 32
    a = jbin.bin_gaussians(pj, 6, 5, P, K, dense=dense, stream=True, **band)
    b = tbin.bin_gaussians(pt, 6, 5, K, dense=dense, max_intersections=P, **band)
    assert int(b.n_truncated) == int(a.n_truncated)
    assert int(b.n_dropped) == int(a.n_dropped)
    if "tile_hi" in band:  # the frame's middle rows: deeper than K
        assert int(b.n_truncated) > 0
    for f in ("counts", "tile_start") + (("gauss_idx",) if dense else ()):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)),
                                      err_msg=f)
    if band.get("band_size") == 16:
        assert (b.counts[12:] == 0).all()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_banded_matches_single_pass_and_jax(layout):
    """tests/test_rasterize.py:184 and tests/test_fuzz_configs.py:73:
    rasterize_banded in 3 bands equals the port's single pass and the JAX
    package's rasterize_banded to 1e-6, its gradients by means, opacities
    and payload the single pass's to 1e-6 and the JAX package's to 1e-3,
    normalised, in each layout (K1 or K5 with the band's tile offset; K2,
    K4 or K6 behind)."""
    means, scales, quats, op, cols = sparse_scene(200, seed=9)
    jc, tc = cams(96, 80)
    jcov, tcov = both_cov(scales, quats)
    bg = np.asarray([0.2, 0.1, 0.3], np.float32)
    tgt = np.random.default_rng(20).uniform(size=(80, 96, 3)).astype(np.float32)
    cfg = RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=8192,
                          **LAYOUTS[layout])
    jcfg = jrast.RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=8192,
                                 backend="xla")

    def run(fn, **kw):
        leaves = [t(x).requires_grad_(True) for x in (means, op, cols)]
        r = fn(tc, leaves[0], tcov, leaves[1], leaves[2], t(bg), cfg, **kw)
        loss = ((r.image - t(tgt)) ** 2).sum() + 0.05 * r.alpha.sum()
        return r, torch.autograd.grad(loss, leaves)

    def jloss(m, o, c):
        r = jrast.rasterize_banded(jc, m, jcov, o, c, jnp.asarray(bg), jcfg, bands=3)
        return jnp.sum((r.image - tgt) ** 2) + 0.05 * jnp.sum(r.alpha), r

    (_, jr), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (means, op, cols)))
    banded, gb = run(rasterize_banded, bands=3)
    full, gf = run(rasterize)
    assert int(banded.n_dropped) == int(banded.n_truncated) == 0
    for k in ("image", "alpha", "depth"):
        got = getattr(banded, k).detach().numpy()
        np.testing.assert_allclose(got, getattr(full, k).detach().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, np.asarray(getattr(jr, k)), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert torch.equal(banded.radii, full.radii)
    for name, a, b, c in zip(("means", "opacities", "payload"), gb, gf, jg):
        assert_normalised(a.numpy(), b.numpy(), 1e-6, name)
        assert_normalised(a.numpy(), np.asarray(c), 1e-3, name)


def test_banded_windows_and_truncation_counts():
    """Tile windows inside bands: each band's windows fold as the single
    pass's do (the images equal), and n_dropped counts the frame's dropped
    slots once while n_truncated sums the bands', as the JAX package's
    rasterize_banded counts them."""
    from tests.test_torch_windows import WIN, deep_scene

    means, scales, quats, op, pay = deep_scene(n=500)
    _, tc = cams(96, 64)
    _, tcov = both_cov(scales, quats)
    args = (tc, t(means), tcov, t(op), t(pay), torch.zeros(3))
    full = rasterize(*args, WIN)
    banded = rasterize_banded(*args, WIN, bands=2)
    np.testing.assert_allclose(banded.image.numpy(), full.image.numpy(), rtol=1e-6, atol=1e-6)
    cut = dataclasses.replace(WIN, tile_windows=1, intersection_budget=1500,
                              min_intersections=0)
    full, banded = rasterize(*args, cut), rasterize_banded(*args, cut, bands=2)
    assert int(banded.n_dropped) == int(full.n_dropped) > 0
    assert int(banded.n_truncated) == int(full.n_truncated) > 0


@pytest.mark.parametrize("nd", [2, 3, 8])
def test_band_totals_match_jax(nd):
    """_band_totals over each rank's rows of an nd-rank mesh's bands equals
    the JAX package's (budget.py:_band_totals)."""
    pj, pt = _projections(w=128, h=128, n=300)
    gx = gy = 8
    tl = -(-(gx * gy) // nd)
    lo = np.array([(i * tl) // gx for i in range(nd)], np.int32)
    hi = np.array([((i + 1) * tl - 1) // gx + 1 for i in range(nd)], np.int32)
    a = jbudget._band_totals(pj, jnp.asarray(lo), jnp.asarray(hi))
    b = budget._band_totals(pt, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(b.sum()) >= int(pt.num_tiles.sum())
