"""The compact stream backward (K4, `blend_stream_bwd_compact`) against the
JAX package's Pallas kernel `blend_stream_pallas_bwd_compact` (interpret
mode), against K2 + K3 per splat, and through `rasterize` with
RasterizeConfig(bwd_layout="compact").

Traps to rule out before filing a mismatch as a fault:
  * Ids: the JAX kernel passes each slot's id through an f32 column of its
    rows; a chunk it skips after every pixel stopped is zero-written, id
    column included, and the tail rows of a tile's last chunk carry the ids
    of whatever rows follow in the stream. The port writes the slot's splat
    id on every row k < counts[t] and n past it, so ids are compared on the
    rows the JAX kernel walked.
  * Row layout: the JAX rows are lane-padded to 128 columns with K rows of
    zero padding (tests/test_torch_blend.py:_padded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops.projection import build_cov3d as jbuild_cov3d
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu.ops.rasterize_pallas import LANES, blend_stream_pallas_bwd_compact
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops.projection import build_cov3d
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    blend_stream_bwd,
    blend_stream_bwd_compact,
    blend_stream_bwd_compact_plain,
    compact_offsets,
    compact_rows,
    segment_reduce,
)
from tests.test_rasterize import make_cam
from tests.test_torch_gpu import CHUNK, GRID_X, make_bwd_stream
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

K = 160  # the JAX kernel's per-tile window: a multiple of CHUNK above every count


def jax_compact(rows, counts, tstart, toff, acc, t_final, g_acc, g_t, nc):
    """The JAX kernel on the same stream, its id column holding slot + 1
    (so a zero-written chunk reads id 0). -> ([nc * CHUNK, F] rows, ids)."""
    P, F = rows.shape
    padded = np.zeros((P + K, LANES), np.float32)
    padded[:P, :F] = rows
    padded[:P, F] = np.arange(1, P + 1, dtype=np.float32)
    out = np.asarray(blend_stream_pallas_bwd_compact(
        jnp.asarray(padded), jnp.asarray(counts), jnp.asarray(tstart), jnp.asarray(acc),
        jnp.asarray(t_final), jnp.asarray(g_acc), jnp.asarray(g_t), GRID_X, CHUNK, K,
        F + 1, nc + 2, jnp.asarray(toff)))
    return out[:nc * CHUNK, :F], out[:nc * CHUNK, F].astype(np.int64)


def test_plain_compact_matches_pallas():
    """Every live row's gradients; ids on the rows the JAX kernel walked;
    zeros and id n on each last chunk's tail. The output's length is the
    bound compact_rows(P, T, chunk), as the JAX kernel's max_chunks buffer,
    and every row past the tiles' NC chunks has id n (and, in the plain
    version, zeros)."""
    stream = make_bwd_stream()
    rows, counts = stream[:2]
    t = tuple(map(torch.as_tensor, stream))
    P = rows.shape[0]
    sorted_gauss = torch.arange(1, P + 1, dtype=torch.int32)  # slot + 1, as the JAX ids
    n = P + 1
    d_all, ids_all = blend_stream_bwd_compact(*t[:4], sorted_gauss, *t[4:], GRID_X, CHUNK,
                                              n)
    cstart, nc = compact_offsets(t[1], CHUNK)
    assert nc == int(((counts + CHUNK - 1) // CHUNK).sum())
    R = (P + len(counts) * (CHUNK - 1)) // CHUNK * CHUNK
    assert compact_rows(P, len(counts), CHUNK) == R > nc * CHUNK
    assert d_all.shape == (R, rows.shape[1]) and ids_all.shape == (R,)
    assert (ids_all[nc * CHUNK:] == n).all() and not d_all[nc * CHUNK:].any()
    d, ids = d_all[:nc * CHUNK], ids_all[:nc * CHUNK]
    want, jids = jax_compact(*stream, nc)
    np.testing.assert_allclose(d.numpy(), want, atol=3e-5, rtol=1e-4)
    owned = -(-counts // CHUNK) * CHUNK
    k = np.concatenate([np.arange(o) for o in owned])
    live = k < np.repeat(counts, owned)
    slot = np.repeat(stream[2], owned) + k  # tstart[t] + k
    walked = jids != 0
    np.testing.assert_array_equal(ids.numpy()[live & walked], jids[live & walked])
    np.testing.assert_array_equal(ids.numpy()[live], slot[live] + 1)
    assert (ids.numpy()[~live] == n).all() and not d.numpy()[~live].any()
    # the fixture exercises what it claims: tile 0 stops early, so whole live
    # chunks are zero-written, and some last chunks have a tail
    skipped = live & ~walked
    assert skipped.sum() >= CHUNK and not d.numpy()[skipped].any()
    assert (~live).any() and int(cstart[-1]) == nc  # the last tile is empty


def test_compact_plus_reduce_equals_k2_plus_reduce():
    """K4 + K3 and K2 + K3 give every splat the same sums."""
    stream = make_bwd_stream(seed=3)
    t = tuple(map(torch.as_tensor, stream))
    P = stream[0].shape[0]
    n = 57
    sorted_gauss = torch.as_tensor(np.random.default_rng(0).integers(0, n, P), dtype=torch.int32)
    d, ids = blend_stream_bwd_compact(*t[:4], sorted_gauss, *t[4:], GRID_X, CHUNK, n)
    per = segment_reduce(d, ids, n)
    d2 = blend_stream_bwd(*t, GRID_X, CHUNK)
    per2 = segment_reduce(d2, sorted_gauss, n)
    np.testing.assert_allclose(per.numpy(), per2.numpy(), atol=1e-5 * float(per2.abs().max()),
                               rtol=1e-4)
    assert float(per2.abs().max()) > 0


def test_plain_compact_handles_empty_and_all_zero_counts():
    """Sweep 2 renders groups with no splats: all counts 0 own no chunk, so
    every row of the bounded output is zero with id n, which K3 drops."""
    stream = list(make_bwd_stream())
    stream[1] = np.zeros_like(stream[1])
    t = tuple(map(torch.as_tensor, stream))
    P, F = stream[0].shape
    d, ids = blend_stream_bwd_compact_plain(*t[:4], torch.zeros(P, dtype=torch.int32),
                                            *t[4:], GRID_X, CHUNK, 5)
    R = compact_rows(P, len(stream[1]), CHUNK)
    assert d.shape == (R, F) and ids.shape == (R,) and R > 0
    assert not d.any() and (ids == 5).all()
    assert not segment_reduce(d, ids, 5).any()


def test_compact_wrapper_validates_inputs():
    t = tuple(map(torch.as_tensor, make_bwd_stream()))
    P = t[0].shape[0]
    with pytest.raises(ValueError, match="sorted_gauss must be int32"):
        blend_stream_bwd_compact(*t[:4], torch.zeros(P, dtype=torch.int64), *t[4:], GRID_X,
                                 CHUNK, 3)
    with pytest.raises(ValueError, match="sorted_gauss must be int32"):
        blend_stream_bwd_compact(*t[:4], torch.zeros(P - 1, dtype=torch.int32), *t[4:],
                                 GRID_X, CHUNK, 3)
    with pytest.raises(ValueError, match="g_t must be float32"):
        blend_stream_bwd_compact(*t[:4], torch.zeros(P, dtype=torch.int32), *t[4:7],
                                 t[7][:, :8], GRID_X, CHUNK, 3)


def stacked_opaque_scene():
    """tests/test_pallas.py:73-109: stacked opaque splats early-stop most
    tiles in the middle of their chunk list."""
    n = 80
    rng = np.random.default_rng(5)
    means = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n),
                      np.linspace(2, 4, n)], -1).astype(np.float32)
    scales = np.full((n, 3), 0.3, np.float32)
    quats = np.tile(np.float32([1, 0, 0, 0]), (n, 1))
    op = np.full((n,), 0.97, np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    target = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    return means, scales, quats, op, cols, target


def test_rasterize_compact_grads_match_jax():
    """rasterize's gradients with bwd_layout "compact" and "auto" against
    the JAX package's compact layout (Pallas, interpret mode)."""
    means, scales, quats, op, cols, target = stacked_opaque_scene()
    jcfg = JConfig(max_per_tile=128, chunk=32, min_intersections=16384, backend="pallas",
                   bwd_layout="compact")

    def jloss(m, o, c):
        out = jrasterize(make_cam(32, 32), m, jbuild_cov3d(scales, quats), o, c,
                         jnp.zeros(3), jcfg)
        return jnp.sum((out.image - target) ** 2) + 0.05 * jnp.sum(out.alpha)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (means, op, cols)))
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 32, 32)
    grads = {}
    for layout in ("compact", "auto"):
        leaves = [torch.tensor(x, requires_grad=True) for x in (means, op, cols)]
        cfg = RasterizeConfig(max_per_tile=128, chunk=32, bwd_layout=layout)
        out = rasterize(cam, leaves[0], build_cov3d(*map(torch.as_tensor, (scales, quats))),
                        leaves[1], leaves[2], torch.zeros(3), cfg)
        loss = ((out.image - torch.as_tensor(target)) ** 2).sum() + 0.05 * out.alpha.sum()
        grads[layout] = torch.autograd.grad(loss, leaves)
        for name, got, w in zip(("means", "op", "cols"), grads[layout], want):
            assert_normalised(got.numpy(), w, 1e-3, f"{name} ({layout})")
    for a, b in zip(grads["compact"], grads["auto"]):
        torch.testing.assert_close(a, b, atol=1e-6 * float(b.abs().max()), rtol=1e-5)


def test_config_rejects_unknown_layouts():
    for layout in ("auto", "dense", "compact"):
        assert RasterizeConfig(bwd_layout=layout).bwd_layout == layout
    with pytest.raises(ValueError, match="bwd_layout"):
        RasterizeConfig(bwd_layout="sparse")
    assert RasterizeConfig(group_render="scan").group_render == "scan"
    assert RasterizeConfig(group_render="dense").group_render == "dense"
    with pytest.raises(ValueError, match="group_render"):
        RasterizeConfig(group_render="vmap")
    # the JAX package's fields of the same names take the same values
    assert dataclasses.replace(JConfig(), bwd_layout="compact").bwd_layout == "compact"
