"""The per-splat reduce's fixed order (RasterizeConfig.reduce_backend) on the
CPU, against the JAX package.

The port's default backend, "sorted_mxu" as in the JAX package, sums each
splat's gradient rows in the order its slots take in the sorted stream,
read off the binning's sort (`TileBins.slot_pos`, `splat_end`) by K3's
permutation entry, whose plain version runs here; "scatter" is K3's atomic
entry. The JAX functions run as tests/test_pallas.py runs them: the Pallas
kernels (its sorted_segment_reduce among them) in interpret mode.
Tolerances: the reduce's sums to atol 2e-5 (tests/test_torch_blend.py's),
gradients to 1e-3 of the largest (tests/test_pallas.py's), images to atol
3e-5; the port's two backends and its layouts against each other bit for
bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu.ops import rasterize_pallas as rp
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops import rasterize as trast
from opengaussian_tpu_torch.ops.rasterize import (
    RasterizeConfig,
    build_frozen_plan,
    rasterize,
    rasterize_groups,
    stack_plans,
)
from opengaussian_tpu_torch.ops.rasterize_kernels import (
    compact_positions,
    segment_reduce_perm,
    segment_reduce_perm_plain,
    segment_reduce_plain,
    segment_reduce_sorted,
)
from opengaussian_tpu_torch.refine.sam_refiner import add_votes
from tests.test_rasterize import make_cam, random_scene
from tests.test_torch_gpu import CHUNK, ORDER_KINDS, make_order_bins, walked_rows
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

BACKENDS = ("sorted_mxu", "scatter")
LAYOUTS = {"stream": {}, "compact": {"bwd_layout": "compact"},
           "dense": {"pallas_input": "dense"}}
GRAD_TOL = 1e-3


def test_reduce_backend_resolves_as_jax(monkeypatch):
    """The field, its values, its default and what "auto" means are the JAX
    package's; "auto" reads the module default when it is resolved."""
    assert RasterizeConfig().reduce_backend == jrast.RasterizeConfig().reduce_backend == "auto"
    assert trast.REDUCE_BACKEND == rp.REDUCE_BACKEND == "sorted_mxu"
    assert RasterizeConfig().resolved_reduce_backend() == rp.REDUCE_BACKEND
    assert RasterizeConfig().fixed_reduce_order()
    for b in BACKENDS:
        cfg = RasterizeConfig(reduce_backend=b)
        assert cfg.resolved_reduce_backend() == b
        assert cfg.fixed_reduce_order() == (b == "sorted_mxu")
    with pytest.raises(ValueError, match="reduce_backend"):
        RasterizeConfig(reduce_backend="mxu")
    monkeypatch.setattr(trast, "REDUCE_BACKEND", "scatter")
    assert not RasterizeConfig().fixed_reduce_order()


@pytest.mark.parametrize("kind", ORDER_KINDS)
def test_slot_order_lists_each_splats_positions_ascending(kind):
    """On a real binning (per-frame P, a fixed P that drops slots or pads
    dead ones, a band, windows, partition groups): slot_pos is a
    permutation of the stream, each splat's range holds only its own slots
    (or slots of id n: culled or dead), and the positions some tile walks
    ascend within each splat's range."""
    bins, n = make_order_bins(kind)
    P = bins.sorted_gauss.shape[0]
    pos, ends = bins.slot_pos.long(), bins.splat_end.long()
    assert pos.shape == (P,) and ends.shape == (n,)
    assert torch.equal(torch.sort(pos).values, torch.arange(P))
    walked = compact_positions(bins.tile_start, bins.counts, CHUNK, P) >= 0
    assert bool(walked.any()) and not bool(walked.all())
    ids = bins.sorted_gauss.long()
    lo = 0
    for i, hi in enumerate(ends.tolist()):
        q = pos[lo:hi]
        assert bool(((ids[q] == i) | (ids[q] == n)).all()), i
        w = q[walked[q]]
        assert bool((w[1:] > w[:-1]).all()), i
        lo = hi
    assert lo <= P and bool((ids[pos[lo:]] == n).all())


@pytest.mark.parametrize("kind", ORDER_KINDS)
def test_perm_plain_is_the_plain_reduce_and_jax(kind):
    """The permutation entry's plain version (what its wrapper runs on the
    CPU) equals the atomic entry's and the sorted entry's plain versions
    bit for bit on rows laid out as K2's, and the JAX package's
    sorted_segment_reduce (interpret mode) within 2e-5."""
    bins, n = make_order_bins(kind)
    rows = walked_rows(bins, 10)
    want = segment_reduce_plain(rows, bins.sorted_gauss, n)
    got = segment_reduce_perm(rows, bins.slot_pos, bins.splat_end, n)
    assert torch.equal(got, want)
    assert torch.equal(segment_reduce_sorted(rows, bins.sorted_gauss, n), want)
    jx = rp.sorted_segment_reduce(jnp.asarray(rows.numpy()),
                                  jnp.asarray(bins.sorted_gauss.numpy()), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=2e-5)


def test_perm_plain_groups_and_compact_rows():
    """Over G = 3 slabs the entry sums each slab alone; over the compact
    layout's rows (NaN where no tile owns a row) through compact_positions
    it gives the stream rows' sums bit for bit."""
    bins, n = make_order_bins("windows")
    P = bins.sorted_gauss.shape[0]
    slabs = [walked_rows(bins, 13, seed) for seed in (1, 2, 3)]
    got = segment_reduce_perm_plain(torch.cat(slabs), bins.slot_pos, bins.splat_end, n, 3)
    want = torch.cat([segment_reduce_plain(r, bins.sorted_gauss, n) for r in slabs])
    assert torch.equal(got, want)
    at = compact_positions(bins.tile_start, bins.counts, CHUNK, P)
    rows_c = torch.full((int(at.max()) + 5, 13), float("nan"))
    rows_c[at[at >= 0].long()] = slabs[0][at >= 0]
    got_c = segment_reduce_perm(rows_c, at[bins.slot_pos.long()], bins.splat_end, n)
    assert torch.equal(got_c, want[:n])


def _jcfg(backend: str, layout: str) -> jrast.RasterizeConfig:
    return jrast.RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=16384,
                                 backend="pallas", reduce_backend=backend, **LAYOUTS[layout])


def _tcfg(backend: str, layout: str) -> RasterizeConfig:
    return RasterizeConfig(max_per_tile=128, chunk=32, reduce_backend=backend,
                           **LAYOUTS[layout])


@pytest.fixture(scope="module")
def grad_scene():
    """tests/test_pallas.py:43-70's scene and loss, its gradients through the
    port under each backend and layout."""
    means, scales, quats, op, cols = random_scene(120, seed=3)
    target = np.random.default_rng(4).uniform(size=(32, 48, 3)).astype(np.float32)
    args = tuple(np.asarray(a) for a in (means, scales, quats, op, cols))
    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 48, 32)
    port = {}
    for b in BACKENDS:
        for lay in LAYOUTS:
            t = [torch.tensor(a, requires_grad=True) for a in args]
            out = rasterize(tc, t[0], tproj.build_cov3d(t[1], t[2]), t[3], t[4],
                            torch.zeros(3), _tcfg(b, lay))
            loss = ((out.image - torch.as_tensor(target)) ** 2).sum() + 0.05 * out.alpha.sum()
            port[b, lay] = [g.numpy() for g in torch.autograd.grad(loss, t)]
    return args, target, port


def test_backends_and_layouts_agree_bit_for_bit(grad_scene):
    """On the CPU every layout under either backend gives the same
    gradients bit for bit: the plain versions of both entries sum in row
    order, and the compact rows reach the permutation entry in the stream's
    order."""
    _, _, port = grad_scene
    want = port["sorted_mxu", "stream"]
    for key, got in port.items():
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(key))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_rasterize_grads_match_jax_per_backend(grad_scene, backend, layout):
    """Per-splat gradients through rasterize under each backend and layout
    against the JAX package's under the same backend and layout
    (tests/test_pallas.py:99's comparison), within 1e-3 of the largest."""
    args, target, port = grad_scene
    cam = make_cam(48, 32)
    cfg = _jcfg(backend, layout)

    def jloss(means, scales, quats, op, cols):
        out = jrast.rasterize(cam, means, jproj.build_cov3d(scales, quats), op, cols,
                              jnp.zeros(3), cfg)
        return jnp.sum((out.image - target) ** 2) + 0.05 * jnp.sum(out.alpha)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    for name, g, w in zip(("means", "scales", "quats", "op", "cols"),
                          port[backend, layout], want):
        assert_normalised(g, w, GRAD_TOL, f"{name} ({backend}, {layout})")


def _plan_scene(n=300, seed=1):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(0, 0.6, n), rng.normal(0, 0.45, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32)
    scales = np.exp(rng.normal(np.log(0.13), 0.3, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(0.5, 1.5, n)))).astype(np.float32)
    payload = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, payload


def test_frozen_step_with_reduce_plan_matches_jax():
    """A frozen step under "sorted_mxu": the port's plan carries the reduce
    order (slot_pos, splat_end: the JAX package's ReducePlan), its
    gradients equal the fresh binning's bit for bit, and match the JAX
    frozen step with reduce_backend="sorted_mxu" and its ReducePlan within
    1e-3 of the largest; the image within 3e-5."""
    means, scales, quats, opac, payload = _plan_scene()
    jcam = JCamera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48)
    cam = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 1.0, 0.8, 64, 48)
    jcfg = jrast.RasterizeConfig(max_per_tile=128, chunk=32, backend="pallas",
                                 min_intersections=4096, reduce_backend="sorted_mxu")
    cfg = RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=4096)
    cov = np.asarray(jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats)))
    jargs = tuple(map(jnp.asarray, (means, cov, opac)))
    jplan = jrast.build_frozen_plan(jcam, *jargs, jcfg)
    assert jplan.reduce is not None
    w = np.linspace(0.0, 1.0, 64 * 48 * 3, dtype=np.float32).reshape(48, 64, 3)

    def jloss(op, pay):
        out = jrast.rasterize(jcam, jargs[0], jargs[1], op, pay, jnp.zeros(3), jcfg,
                              frozen=jplan)
        return jnp.sum(out.image * w) + 0.1 * jnp.sum(out.alpha), out.image

    (_, jimg), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(opac), jnp.asarray(payload))
    targs = tuple(map(torch.tensor, (means, cov, opac)))
    plan = build_frozen_plan(cam, *targs, cfg)
    assert plan.slot_pos is not None and plan.splat_end is not None
    assert int(plan.total) == int(jplan.total)

    def tgrads(frozen):
        o = torch.tensor(opac, requires_grad=True)
        p = torch.tensor(payload, requires_grad=True)
        out = rasterize(cam, targs[0], targs[1], o, p, torch.zeros(3), cfg, frozen=frozen)
        loss = (out.image * torch.as_tensor(w)).sum() + 0.1 * out.alpha.sum()
        return out.image.detach(), torch.autograd.grad(loss, [o, p])

    img, got = tgrads(plan)
    _, fresh = tgrads(None)
    for g, f in zip(got, fresh):
        assert torch.equal(g, f)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5, rtol=1e-4)
    for name, g, j in zip(("opacity", "payload"), got, jg):
        assert_normalised(g.numpy(), j, GRAD_TOL, name)


def test_plans_carry_the_order_and_scatter_plans_none():
    """stack_plans and select carry the order (slot_pos padded past every
    splat's range), nbytes counts it; a plan built under "scatter" carries
    none, and a "sorted_mxu" step through it raises rather than fall back
    to the atomic entry."""
    means, scales, quats, opac, payload = _plan_scene(n=200, seed=2)
    cov = tproj.build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats))
    m, o = torch.as_tensor(means), torch.as_tensor(opac)
    cams = [tcam.Camera.from_fov(np.eye(3), np.array([dx, 0.0, 0.0]), 1.0, 0.8, 64, 48)
            for dx in (0.0, 0.3)]
    cfg = RasterizeConfig(max_per_tile=128, chunk=32, min_intersections=4096)
    plans = [build_frozen_plan(c, m, cov, o, cfg) for c in cams]
    assert plans[0].g_sorted.shape != plans[1].g_sorted.shape
    stacked = stack_plans(plans, len(means))
    for i, p in enumerate(plans):
        s = stacked.select(torch.tensor([i]))
        L = p.slot_pos.shape[0]
        assert torch.equal(s.slot_pos[:L], p.slot_pos) and torch.equal(s.splat_end, p.splat_end)
    base = dataclasses.replace(plans[0], slot_pos=None, splat_end=None)
    assert plans[0].nbytes() == base.nbytes() + plans[0].slot_pos.nbytes + 200 * 4
    scatter = dataclasses.replace(cfg, reduce_backend="scatter")
    plan_s = build_frozen_plan(cams[0], m, cov, o, scatter)
    assert plan_s.slot_pos is None and plan_s.splat_end is None
    pay = torch.as_tensor(payload).requires_grad_(True)
    with pytest.raises(ValueError, match="reduce's order"):
        rasterize(cams[0], m, cov, o, pay, torch.zeros(3), cfg, frozen=plan_s)
    with torch.no_grad():  # no backward follows: no order needed
        rasterize(cams[0], m, cov, o, pay, torch.zeros(3), cfg, frozen=plan_s)


def test_group_renders_agree_across_backends():
    """rasterize_groups (the group entries, G = 3) gives the same gradients
    bit for bit under either backend on the CPU."""
    means, scales, quats, op, cols = (np.asarray(a) for a in random_scene(150, seed=5))
    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 48, 32)
    masks = np.random.default_rng(6).uniform(size=(3, 150)) < 0.5
    grads = {}
    for b in BACKENDS:
        o = torch.tensor(op, requires_grad=True)
        c = torch.tensor(cols, requires_grad=True)
        og = torch.where(torch.as_tensor(masks), o[None, :], 0.0)
        out = rasterize_groups(tc, torch.as_tensor(means),
                               tproj.build_cov3d(torch.as_tensor(scales), torch.as_tensor(quats)),
                               og, c, torch.zeros(3), _tcfg(b, "dense"))
        loss = (out.image * torch.linspace(0, 1, out.image.numel()).reshape(out.image.shape)).sum()
        grads[b] = torch.autograd.grad(loss + out.alpha.sum(), [o, c])
    for g, w in zip(grads["sorted_mxu"], grads["scatter"]):
        assert torch.equal(g, w) and bool(w.abs().max() > 0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refiner_votes_add_in_index_add_order(backend):
    """add_votes (the SAM refiner's vote scatter) adds into the votes in
    index_add_'s order under either backend: bit for bit on the CPU, ids
    repeated, votes already nonzero, and the rows that are not live (zero,
    id 0: a tile's padding) left out or added alike."""
    rng = np.random.default_rng(8)
    votes = torch.as_tensor(rng.uniform(0, 1, (50, 4)).astype(np.float32))
    live = torch.as_tensor(rng.uniform(size=700) < 0.6)
    ids = torch.where(live, torch.as_tensor(rng.integers(0, 50, 700)), 0)
    rows = torch.as_tensor(rng.normal(0, 1, (700, 4)).astype(np.float32))
    rows = torch.where(live[:, None], rows, 0.0)
    want = votes.clone().index_add_(0, ids, rows)
    got = add_votes(votes.clone(), ids, rows, live, RasterizeConfig(reduce_backend=backend))
    assert torch.equal(got, want)
