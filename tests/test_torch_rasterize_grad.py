"""Gradients of the port's render path against the JAX package's.

The same seeded numpy inputs go through `jax.vjp`/`jax.grad` of the JAX
functions (the rasterizer with its Pallas stream kernels in interpret mode,
as tests/test_pallas.py runs them) and through torch.autograd of the port's
(whose blend backward runs the plain versions of K2 and K3 on the CPU).

Traps to rule out before filing a mismatch as a fault:
  * A torch.where whose unused branch has an infinite derivative (sqrt or
    log at 0) turns a zero cotangent into NaN; the JAX package guards these
    with double wheres. Every gradient here is asserted finite, and the
    projection fixture holds splats behind the near plane and splats of
    opacity 0 (the tight radius's sqrt(log(255 o)) at 0).
  * torch.clamp passes the whole gradient at a tie with its bound, where
    jnp.maximum/jnp.clip split it; a tie needs an input exactly on a bound,
    which the seeded fixtures do not hold.
  * The blend's per-slot gradients are sums over a tile's 256 pixels, taken
    in another order by each package; near-cancelling sums differ by ~1e-6
    of the largest gradient, hence the normalised comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import sh as jsh
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.ops.rasterize import rasterize as jrasterize
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.ops import projection as tproj
from opengaussian_tpu_torch.ops import sh as tsh
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from tests.test_rasterize import make_cam, random_scene

torch.set_num_threads(1)

JCFG = JConfig(max_per_tile=128, chunk=32, min_intersections=16384, backend="pallas")
TCFG = RasterizeConfig(max_per_tile=128, chunk=32)


def _t(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def assert_normalised(got, want, atol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), f"{name}: non-finite gradient"
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("tight", [False, True])
def test_project_vjp_matches_jax(tight):
    """Every float field of Projected that the blend differentiates (mean2d,
    depth, conic) pulls back to means3d, cov3d and the screen tap as the
    JAX package's VJP does."""
    means, scales, quats, op, _ = random_scene(300, seed=4, zmin=0.1, zmax=6.0)
    op = np.array(op)
    op[:20] = 0.0  # dead splats: opacity exactly 0
    cov = np.asarray(jproj.build_cov3d(scales, quats))
    tap = np.zeros((300, 2), np.float32)
    rng = np.random.default_rng(5)
    cts = {f: rng.normal(size=s).astype(np.float32)
           for f, s in (("mean2d", (300, 2)), ("depth", (300,)), ("conic", (300, 3)))}
    jc = make_cam(96, 80)

    def jfn(m, c, tp):
        p = jproj.project(m, c, jc, screen_tap=tp, opacities=jnp.asarray(op) if tight else None)
        return p.mean2d, p.depth, p.conic

    _, vjp = jax.vjp(jfn, jnp.asarray(means), jnp.asarray(cov), jnp.asarray(tap))
    want = vjp(tuple(jnp.asarray(cts[f]) for f in ("mean2d", "depth", "conic")))

    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 96, 80)
    m, c, tp = _t(means, True), _t(cov, True), _t(tap, True)
    p = tproj.project(m, c, tc, opacities=_t(op) if tight else None, screen_tap=tp)
    loss = sum((getattr(p, f) * _t(cts[f])).sum() for f in cts)
    got = torch.autograd.grad(loss, (m, c, tp))
    for name, g, w in zip(("means3d", "cov3d", "screen_tap"), got, want):
        assert_normalised(g.numpy(), w, 1e-5, name)
    assert not np.asarray(jfn(jnp.asarray(means), jnp.asarray(cov), None)[1] > 0.2).all()


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_to_rgb_grads_match_jax(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(0, 1.5, (100, 16, 3)).astype(np.float32)
    means = rng.normal(size=(100, 3)).astype(np.float32)
    center = np.array([0.1, -0.3, 2.0], np.float32)
    ct = rng.normal(size=(100, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda c, m: jsh.sh_to_rgb(deg, c, m, jnp.asarray(center)),
                     jnp.asarray(coeffs), jnp.asarray(means))
    want = vjp(jnp.asarray(ct))
    c, m = _t(coeffs, True), _t(means, True)
    rgb = tsh.sh_to_rgb(deg, c, m, _t(center))
    assert bool((rgb == 0).any())  # the clamp at 0 fires somewhere
    got = torch.autograd.grad((rgb * _t(ct)).sum(), (c, m), allow_unused=True)
    for name, g, w in zip(("coeffs", "means"), got, want):
        if g is None:  # degree 0 does not read the view direction
            assert name == "means" and deg == 0 and not np.asarray(w).any()
            continue
        assert_normalised(g.numpy(), w, 1e-5, name)


def test_rasterize_grads_match_jax():
    """tests/test_pallas.py:43-70's scene and loss, plus the screen tap."""
    means, scales, quats, op, cols = random_scene(120, seed=3)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    target = np.random.default_rng(4).uniform(size=(32, 48, 3)).astype(np.float32)
    tap = np.zeros((120, 2), np.float32)
    cam = make_cam(48, 32)

    def jloss(means, scales, quats, op, cols, tap):
        out = jrasterize(cam, means, jproj.build_cov3d(scales, quats), op, cols,
                         jnp.asarray(bg), JCFG, tap)
        return (jnp.sum((out.image - target) ** 2) + 0.05 * jnp.sum(out.alpha)
                + 0.01 * jnp.sum(out.depth))

    args = (means, scales, quats, op, cols, jnp.asarray(tap))
    want = jax.grad(jloss, argnums=tuple(range(6)))(*args)

    tc = tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 48, 32)
    targs = [_t(a, True) for a in args]
    m, s, q, o, c, tp = targs
    out = rasterize(tc, m, tproj.build_cov3d(s, q), o, c, _t(bg), TCFG, tp)
    assert int(out.n_truncated) == 0
    loss = ((out.image - _t(target)) ** 2).sum() + 0.05 * out.alpha.sum() \
        + 0.01 * out.depth.sum()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(*args)), rtol=1e-5)
    got = torch.autograd.grad(loss, targs)
    for name, g, w in zip(("means", "scales", "quats", "op", "cols", "screen_tap"),
                          got, want):
        assert_normalised(g.numpy(), w, 1e-3, name)
        assert float(np.abs(np.asarray(w)).max()) > 0, name
