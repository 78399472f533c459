"""The geometry kernels (ops/geometry_kernels.py, csrc/geometry.cu): their
plain analytic backward versions against autograd of the plain forwards,
the CPU dispatch, and, on the card, each kernel against its plain version.

This file imports nothing of JAX, so its card cases also run where JAX is
absent:

    python -m pytest -q --noconftest -m gpu tests/test_torch_geometry_kernels.py

The fixture's splats hold every edge case of the gradient rules: behind and
at the near plane, at and past the guard band's clamps, det <= 0 (indefinite
covariances), opacities at and below 1/255, rgb clamped at 0, zero
quaternions and a view vector of zero length.
"""

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.ops import geometry_kernels as gk
from opengaussian_tpu_torch.ops import projection as P
from opengaussian_tpu_torch.ops import sh as S

torch.set_num_threads(1)

W, H = 96, 80
N = 384
K_SH = 25  # coefficients stored: degree 4's, so lower degrees leave a tail


def make_camera(kind: str, dtype=torch.float32, device="cpu") -> Camera:
    """"identity": camera space is world space (so the fixture can place
    splats exactly on the guard band); "rotated": a general pose."""
    if kind == "identity":
        R, t = np.eye(3), np.zeros(3)
    else:
        a, b = 0.4, -0.3
        Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        Rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        R, t = Rx @ Rz, np.array([0.2, -0.1, 0.5])
    cam = Camera.from_fov(R, t, 0.9, 0.7, W, H)
    move = {f: getattr(cam, f).to(device=device, dtype=dtype)
            for f in ("R_w2c", "t_w2c", "fx", "fy", "cx", "cy")}
    return Camera(**move, width=W, height=H)


def make_splats(seed: int = 0, dtype=np.float32) -> dict:
    """N splats in front of a camera at the origin looking down +z, with the
    edge cases in fixed rows; numpy arrays of dtype, whose guard-band rows
    sit exactly on the band of make_camera("identity", dtype)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.normal(0, 0.8, N), rng.normal(0, 0.6, N),
                      rng.uniform(0.5, 6.0, N)], -1)
    scales = np.exp(rng.normal(-2.0, 0.6, (N, 3)))
    quats = rng.normal(size=(N, 4))
    opac = rng.uniform(0.05, 0.99, N)
    sh = rng.normal(0, 0.4, (N, K_SH, 3))
    tap = rng.normal(0, 1e-3, (N, 2))
    fx, fy = (dtype(np.float32(S / (2 * np.tan(f / 2)))) for S, f in ((W, 0.9), (H, 0.7)))
    lx = dtype(1.3) * (dtype(W) / (dtype(2) * fx))  # Camera.tanfovx's rounding
    ly = dtype(1.3) * (dtype(H) / (dtype(2) * fy))
    means[0:8, 2] = [-1.0, -0.1, 0.0, 0.1, 0.2, 0.2, 0.19, -3.0]  # behind / at the plane
    means[8:12] = [[2 * lx, 0.1, 2.0], [-2 * lx, -2 * ly, 2.0], [0.3, 2 * ly, 2.0],
                   [2 * lx, 2 * ly, 2.0]]  # on the guard band, exactly
    means[12:18, 0] = means[12:18, 2] * 3 * lx * np.array([1, -1, 1, -1, 2, -2])  # past it
    means[18:22, 1] = means[18:22, 2] * 4 * ly * np.array([1, -1, 1, -1])
    means[22:30] = [0.0, 0.0, 3.0]
    opac[22:30] = [1 / 255, 0.5 / 255, 0.0, -0.1, 0.99 / 255, 1.01 / 255, 2 / 255, 1e-6]
    quats[30:36] = 0.0  # dead padded splats
    sh[36:60, 0, :] = -3.0  # rgb clamped at 0
    sh[36:60, 1:, :] *= 0.05
    means[60] = 0.0  # the camera centre: a view vector of zero length
    scales[61:64] = [1e-4, 2e-4, 3e-4]  # tiny: the radius from the dilation
    out = dict(means=means, scales=scales, quats=quats, opac=opac, sh=sh, tap=tap)
    return {k: v.astype(dtype) for k, v in out.items()}


def indefinite_cov(cov: np.ndarray) -> np.ndarray:
    """cov with rows 64-79 replaced by indefinite matrices, whose cov2d
    under the fixture's camera has det <= 0 for most of them."""
    cov = cov.copy()
    rng = np.random.default_rng(7)
    for i in range(64, 80):
        s = rng.uniform(0.05, 0.5)
        cov[i] = np.diag([s, -s, rng.uniform(-s, s)])
    return cov


def tensors(d: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in d.items()}


def leaves(*xs):
    return [x.detach().clone().requires_grad_(True) for x in xs]


def cotangent(shape, seed, dtype, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype=dtype, device=device)


def assert_close(a, b, rtol, name):
    """Each splat's |a - b| within rtol of its largest |b| (a row of zeros
    matched exactly), both finite. Per splat, since the rows' magnitudes
    differ by orders (a zero view vector's direction gradient is ~1e12)."""
    assert a.shape == b.shape, name
    assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    scale = b.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    err = ((a - b).abs() / scale).max()
    assert err <= rtol, f"{name}: {float(err):.3e} of a splat's largest value"


# --------------------------------------------------------------------------
# the plain analytic backward versions against autograd, in float64


def test_cov3d_bwd_plain_matches_autograd():
    t = tensors(make_splats(dtype=np.float64))
    s, q = leaves(t["scales"], t["quats"])
    g = cotangent((N, 3, 3), 1, torch.float64)
    (P.build_cov3d_plain(s, q) * g).sum().backward()
    ds, dq = gk.cov3d_bwd_plain(t["scales"], t["quats"], g)
    assert_close(ds, s.grad, 1e-12, "d_scales")
    assert_close(dq, q.grad, 1e-12, "d_quats")
    assert torch.equal(dq[30:36], torch.zeros_like(dq[30:36]))  # zero quaternions


@pytest.mark.parametrize("kind", ["identity", "rotated"])
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("with_tap", [False, True])
def test_project_bwd_plain_matches_autograd(kind, tight, with_tap):
    t = tensors(make_splats(dtype=np.float64))
    cov = torch.as_tensor(indefinite_cov(P.build_cov3d_plain(t["scales"], t["quats"])
                                         .numpy()))
    cam = make_camera(kind, torch.float64)
    m, c, tap = leaves(t["means"], cov, t["tap"])
    p = P.project_plain(m, c, cam, t["opac"] if tight else None, tap if with_tap else None)
    gm, gc, gd = (cotangent(x.shape, i, torch.float64)
                  for i, x in enumerate((p.mean2d, p.conic, p.depth)))
    ((p.mean2d * gm).sum() + (p.conic * gc).sum() + (p.depth * gd).sum()).backward()
    dm, dc, dtap = gk.project_bwd_plain(t["means"], cov, cam, gm, gc, gd, with_tap)
    assert_close(dm, m.grad, 1e-11, "d_means")
    assert_close(dc, c.grad, 1e-11, "d_cov")
    if with_tap:
        assert_close(dtap, tap.grad, 1e-12, "d_tap")
    else:
        assert dtap is None
    # the fixture reaches every rule
    assert kind == "rotated" or not p.valid[:8].any()
    det_bad = (p.conic[64:80, 0] * p.conic[64:80, 2] - p.conic[64:80, 1] ** 2) <= 0
    assert det_bad.any()
    if tight:
        assert (~p.valid[22:30]).sum() >= 3 and p.valid[22:30].any()


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_bwd_plain_matches_autograd(deg):
    t = tensors(make_splats(deg, np.float64))
    center = torch.zeros(3, dtype=torch.float64)
    sh, m = leaves(t["sh"], t["means"])
    rgb = S.sh_to_rgb_plain(deg, sh, m, center)
    assert (rgb[36:60] == 0).all()  # the clamp fires
    g = cotangent((N, 3), 3, torch.float64)
    (rgb * g).sum().backward()
    dsh, dm = gk.sh_bwd_plain(deg, t["sh"], t["means"], center, g)
    assert_close(dsh, sh.grad, 1e-12, "d_sh")
    if deg == 0:  # the constant basis: no gradient through the direction
        assert m.grad is None and torch.equal(dm, torch.zeros_like(dm))
    else:
        assert_close(dm, m.grad, 1e-11, "d_means")


def test_functions_match_autograd_on_cpu():
    """Cov3d, Project and ShColor applied to CPU tensors (the wrappers take
    the plain versions): their backward plumbing gives autograd's
    gradients."""
    t = tensors(make_splats(dtype=np.float64))
    cam = make_camera("rotated", torch.float64)
    center = cam.cam_center

    def chain(fn_cov, fn_proj, fn_sh, s, q, m, sh, tap):
        cov = fn_cov(s, q)
        p = fn_proj(m, cov, cam, t["opac"], tap)
        rgb = fn_sh(3, sh, m, center)
        return (p.mean2d.sum(-1) * p.conic[:, 0] + p.depth * rgb[:, 1] + p.conic[:, 1]).sum()

    plain = leaves(t["scales"], t["quats"], t["means"], t["sh"], t["tap"])
    chain(P.build_cov3d_plain, P.project_plain, S.sh_to_rgb_plain, *plain).backward()
    fused = leaves(t["scales"], t["quats"], t["means"], t["sh"], t["tap"])
    chain(gk.Cov3d.apply, lambda *a: P.Projected(*gk.Project.apply(*a)), gk.ShColor.apply,
          *fused).backward()
    for name, a, b in zip(("scales", "quats", "means", "sh", "tap"), fused, plain):
        assert_close(a.grad, b.grad, 1e-10, name)


def test_cpu_calls_run_the_plain_code():
    """On CPU tensors the three functions are the plain ones, with autograd
    through their ops, and no kernel launches."""
    t = tensors(make_splats())
    cam = make_camera("rotated")
    before = {w: w.launches for w in gk.KERNEL_WRAPPERS}
    s, q, m, sh, tap = leaves(t["scales"], t["quats"], t["means"], t["sh"], t["tap"])
    cov = P.build_cov3d(s, q)
    p = P.project(m, cov, cam, t["opac"], tap)
    rgb = S.sh_to_rgb(3, sh, m, cam.cam_center)
    for out in (cov, p.mean2d, rgb):
        assert "geometry_kernels" not in type(out.grad_fn).__module__
    (p.mean2d.sum() + p.conic.sum() + p.depth.sum() + rgb.sum()).backward()
    assert torch.equal(cov, P.build_cov3d_plain(s, q))
    ref = P.project_plain(m, cov, cam, t["opac"], tap)
    for f in gk.PROJECTED_FIELDS:
        assert torch.equal(getattr(p, f), getattr(ref, f)), f
    assert torch.equal(rgb, S.sh_to_rgb_plain(3, sh, m, cam.cam_center))
    assert all(x.grad is not None for x in (s, q, m, sh, tap))
    assert {w: w.launches for w in gk.KERNEL_WRAPPERS} == before
    assert all(n == 0 for n in before.values())


def test_cotangents_read_in_place():
    """A column block of one [N, F] buffer is read at its row stride; a
    cotangent whose columns are not contiguous is copied."""
    buf = torch.arange(N * 13, dtype=torch.float32).reshape(N, 13)
    x, s = gk._rows(buf[:, 2:5])
    assert s == 13 and x.data_ptr() == buf[:, 2:5].data_ptr()
    x, s = gk._rows(buf[:, 12])
    assert s == 13 and x.data_ptr() == buf[:, 12].data_ptr()
    x, s = gk._rows(buf[:, ::2])
    assert x.is_contiguous() and s == 7 and torch.equal(x, buf[:, ::2])
    assert gk._rows(None) == (None, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    m = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gk.cov3d_fwd(m, torch.zeros((4, 4), device="meta"))
    with pytest.raises(ValueError, match="degree"):
        gk._check_sh(5, torch.zeros((4, 36, 3)), torch.zeros((4, 3)), torch.zeros(3))
    with pytest.raises(ValueError, match="K >= 16"):
        gk._check_sh(3, torch.zeros((4, 9, 3)), torch.zeros((4, 3)), torch.zeros(3))
    with pytest.raises(ValueError, match="float32"):
        gk._check("x", torch.device("cpu"), a=torch.zeros(3, dtype=torch.float64))


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# The forwards evaluate the plain expressions in the order the card's torch
# takes them, library sums included, so they equal the plain versions bit
# for bit; the backwards group the analytic products in their own order.
BWD_RTOL = 1e-4


@pytest.mark.gpu
def test_cov3d_kernel_matches_plain(cuda):
    t = tensors(make_splats(), cuda)
    before = (gk.cov3d_fwd.launches, gk.cov3d_bwd.launches)
    cov = gk.cov3d_fwd(t["scales"], t["quats"])
    assert torch.equal(cov, P.build_cov3d_plain(t["scales"], t["quats"]))
    g = cotangent((N, 3, 3), 1, torch.float32, cuda)
    ds, dq = gk.cov3d_bwd(t["scales"], t["quats"], g)
    ds_p, dq_p = gk.cov3d_bwd_plain(t["scales"], t["quats"], g)
    torch.cuda.synchronize()
    assert (gk.cov3d_fwd.launches, gk.cov3d_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert_close(ds, ds_p, BWD_RTOL, "d_scales")
    assert_close(dq, dq_p, BWD_RTOL, "d_quats")
    assert torch.equal(dq[30:36], torch.zeros_like(dq[30:36]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["identity", "rotated"])
@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("with_tap", [False, True])
def test_project_kernel_matches_plain(cuda, kind, tight, with_tap):
    t = tensors(make_splats(), cuda)
    cov = torch.as_tensor(indefinite_cov(P.build_cov3d_plain(t["scales"], t["quats"])
                                         .cpu().numpy()), device=cuda)
    cam = make_camera(kind, device=cuda)
    opac, tap = t["opac"] if tight else None, t["tap"] if with_tap else None
    out = gk.project_fwd(t["means"], cov, cam, opac, tap)
    ref = P.project_plain(t["means"], cov, cam, opac, tap)
    for f, x in zip(gk.PROJECTED_FIELDS, out):
        assert torch.equal(x, getattr(ref, f)), f
    gm, gc, gd = (cotangent(s, i, torch.float32, cuda)
                  for i, s in enumerate(((N, 2), (N, 3), (N,))))
    got = gk.project_bwd(t["means"], cov, cam, gm, gc, gd, with_tap)
    want = gk.project_bwd_plain(t["means"], cov, cam, gm, gc, gd, with_tap)
    for name, a, b in zip(("d_means", "d_cov", "d_tap"), got, want):
        if b is None:
            assert a is None
        else:
            assert_close(a, b, BWD_RTOL, name)


@pytest.mark.gpu
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_kernel_matches_plain(cuda, deg):
    t = tensors(make_splats(deg), cuda)
    center = torch.tensor([0.1, -0.2, 0.3], device=cuda)
    t["means"][60] = center
    rgb = gk.sh_fwd(deg, t["sh"], t["means"], center)
    assert torch.equal(rgb, S.sh_to_rgb_plain(deg, t["sh"], t["means"], center))
    buf = cotangent((N, 13), 3, torch.float32, cuda)  # d_rgb as a column block
    d_sh, dm = gk.sh_bwd(deg, t["sh"], t["means"], center, buf[:, 6:9])
    d_sh_p, dm_p = gk.sh_bwd_plain(deg, t["sh"], t["means"], center, buf[:, 6:9])
    assert_close(d_sh, d_sh_p, BWD_RTOL, "d_sh")
    assert_close(dm, dm_p, BWD_RTOL, "d_means")


@pytest.mark.gpu
def test_functions_on_the_card_match_plain_autograd(cuda):
    """The chain of the colour pass through the three Functions against
    autograd of the plain chain on the card; one launch of each kernel."""
    t = tensors(make_splats(), cuda)
    cam = make_camera("rotated", device=cuda)
    grads = []
    before = {w: w.launches for w in gk.KERNEL_WRAPPERS}
    for cov_fn, proj_fn, sh_fn in ((P.build_cov3d, P.project, S.sh_to_rgb),
                                   (P.build_cov3d_plain, P.project_plain,
                                    S.sh_to_rgb_plain)):
        x = leaves(t["scales"], t["quats"], t["means"], t["sh"], t["tap"])
        p = proj_fn(x[2], cov_fn(x[0], x[1]), cam, t["opac"], x[4])
        rgb = sh_fn(3, x[3], x[2], cam.cam_center)
        (p.mean2d.sum(-1) * p.conic[:, 0] + p.depth * rgb[:, 1] + p.conic[:, 1]).sum().backward()
        grads.append([y.grad for y in x])
    torch.cuda.synchronize()
    assert all(w.launches == before[w] + 1 for w in gk.KERNEL_WRAPPERS)
    for name, a, b in zip(("scales", "quats", "means", "sh", "tap"), *grads):
        assert_close(a, b, BWD_RTOL, name)
