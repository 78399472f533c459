"""The device mesh: the port's parallel/ (mesh, distributed, the sharded
render and stage-0 step) on two gloo ranks on the CPU, against the JAX
package's single-device rasterize and tuned_config on a 2-device mesh, and
against the port's single-device stage-0 step (tests/test_parallel.py:18-111,
380, tests/test_banded.py, tests/test_windows.py:138).

Every 2-rank scenario runs in one module-scoped spawn of
tests/torch_mesh_worker.py, whose ranks import no JAX and write their
results to .npz files; the tests compare those. The frame, 80x48, has 15
tiles, so the second rank's band reaches past the grid (the sentinel case
JAX's tests reach with 20 tiles on 8 devices).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.models.gaussians import create_from_pcd as jcreate
from opengaussian_tpu.ops import budget as jbudget
from opengaussian_tpu.ops import projection as jproj
from opengaussian_tpu.ops import rasterize as jrast
from opengaussian_tpu.parallel.mesh import make_mesh as jmake_mesh
from opengaussian_tpu_torch.cameras import Camera
from opengaussian_tpu_torch.config import OptimizationConfig
from opengaussian_tpu_torch.models import gaussians as G
from opengaussian_tpu_torch.models import optimizer as opt_mod
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.parallel import distributed, mesh, render
from opengaussian_tpu_torch.train.loop import ViewBundle, stage0_step
from tests import torch_mesh_worker as wk
from tests.test_torch_rasterize_grad import assert_normalised

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TOL = dict(atol=3e-5, rtol=1e-4)  # the repo's image tolerance
JCFG = jrast.RasterizeConfig(backend="xla", **wk.CFG)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run tests/torch_mesh_worker.py on two gloo ranks once -> their
    results, [rank0, rank1] dicts of arrays."""
    out = tmp_path_factory.mktemp("mesh")
    env = {k: v for k, v in os.environ.items() if not k.startswith("OPENGS_")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = ROOT
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"), str(r),
         str(WORLD), str(out / "store"), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


def _jax_render(case):
    means, scales, quats, op, cols = wk.scene_of(case)
    cov = jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, wk.W, wk.H)
    cfg = (jrast.RasterizeConfig(backend="xla", max_per_tile=768, chunk=32,
                                 min_intersections=65536)
           if case.startswith("window") else JCFG)
    return jrast.rasterize(cam, jnp.asarray(means), cov, jnp.asarray(op), jnp.asarray(cols),
                           jnp.asarray([0.1, 0.2, 0.3]), cfg)


@pytest.mark.parametrize("case", [c for c in wk.RENDER_CASES if c != "window_band"])
def test_sharded_render_matches_single_device(ranks, case):
    """tests/test_parallel.py:18 and tests/test_banded.py:35: on both ranks
    the sharded image, alpha and depth equal JAX's single-device rasterize
    to the repo's tolerances, the ranks' radii put together equal its
    radii, and nothing is lost; bands off and on, stream, dense and the
    compact backward's configuration."""
    ref = _jax_render(case)
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/image"], np.asarray(ref.image), **TOL)
        np.testing.assert_allclose(r[f"{case}/alpha"], np.asarray(ref.alpha), **TOL)
        np.testing.assert_allclose(r[f"{case}/depth"], np.asarray(ref.depth), atol=3e-4)
        assert int(r[f"{case}/n_lost"]) == 0
    np.testing.assert_array_equal(np.concatenate([r[f"{case}/radii"] for r in ranks]),
                                  np.asarray(ref.radii))


def test_banded_plus_windowed_mesh(ranks):
    """tests/test_windows.py:138: bands with tile windows on the mesh within
    the windows' T_EPS bound of the deep unwindowed single-device render."""
    ref = _jax_render("window_band")
    for r in ranks:
        assert int(r["window_band/n_lost"]) == 0
        np.testing.assert_allclose(r["window_band/image"], np.asarray(ref.image), atol=2e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(r["window_band/alpha"], np.asarray(ref.alpha), atol=2e-4)


@pytest.mark.parametrize("case", wk.GRAD_CASES)
def test_sharded_gradients_match_single_device(ranks, case):
    """tests/test_parallel.py:40 and tests/test_banded.py:63: the loss and
    the gradients by means and payload, each rank's shard put together,
    equal JAX's single-device ones (1e-3 normalised, the repo's gradient
    tolerance; the JAX tests' own bounds are 1e-4 absolute and 2e-5
    normalised, which these meet too)."""
    means, scales, quats, op, cols = wk.scene_of(case)
    cov = jproj.build_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, wk.W, wk.H)
    tgt = wk.grad_target()

    def loss(m, c):
        out = jrast.rasterize(cam, m, cov, jnp.asarray(op), c, jnp.asarray([0.1, 0.2, 0.3]),
                              JCFG)
        return jnp.sum((out.image - tgt) ** 2)

    l0, (gm, gc) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(means),
                                                            jnp.asarray(cols))
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{case}/loss"]), float(l0), rtol=1e-5)
    for name, want in (("g_means", gm), ("g_cols", gc)):
        got = np.concatenate([r[f"{case}/{name}"] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        assert_normalised(got, np.asarray(want), 2e-5, name)


def test_tight_band_budget_reports_drops(ranks):
    """tests/test_banded.py:127: a band budget below the need shows in
    n_lost, summed over the bands, the same on both ranks."""
    lost = [int(r["tight/n_lost"]) for r in ranks]
    assert lost[0] == lost[1] > 0


def test_band_probe_matches_jax(ranks):
    """tests/test_banded.py:94: tuned_config under the 2-rank mesh (each
    rank probing its own splats) gives the JAX package's budgets on a
    2-device mesh, a band budget below the frame's, and a render at them
    that loses nothing."""
    pts, cols, _ = wk.toy_points(n=128)
    st = jcreate(pts, cols, capacity=128, seed=0)
    jm = jmake_mesh(2)
    st_sh = jax.tree.map(
        lambda x: jax.device_put(
            x, jax.NamedSharding(jm, jax.P("dev", *([None] * (x.ndim - 1)))))
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 128 else x, st)
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 128, 128)
    jt = jbudget.tuned_config(jrast.RasterizeConfig(**wk.CFG), st_sh, [cam], mesh=jm)
    for r in ranks:
        for f in ("intersection_budget", "max_per_tile", "band_intersection_budget"):
            assert int(r[f"probe/{f}"]) == getattr(jt, f), f
        assert 0 < int(r["probe/band_intersection_budget"]) < int(
            r["probe/intersection_budget"])
        assert int(r["probe/n_lost"]) == 0


def _single_device_step():
    """The port's single-device stage-0 step on the worker's toy state, view
    and alpha target."""
    pts, cols, gt = wk.toy_points()
    cam = Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48)
    state = G.create_from_pcd(pts, cols, capacity=128, seed=0, device="cpu")
    adam = opt_mod.init(state.params())
    stats = G.DensifyStats.zeros(128, "cpu")
    one = lambda x: torch.as_tensor(np.asarray(x, np.float32))[None]  # noqa: E731
    bundle = ViewBundle(
        R=cam.R_w2c[None], t=cam.t_w2c[None], fx=cam.fx[None], fy=cam.fy[None],
        cx=cam.cx[None], cy=cam.cy[None], gt_images=one(gt),
        alpha_masks=one(wk.alpha_target()), has_alpha=torch.tensor([True]),
        sam_ids=torch.zeros((1, 48, 64), dtype=torch.int32), width=64, height=48,
        max_masks=8)
    return stage0_step(state, adam, stats, bundle, 0, 1, torch.tensor([0.3, 0.2, 0.1]), 1.0,
                       RasterizeConfig(**wk.CFG), OptimizationConfig())


def test_sharded_stage0_matches_single_device(ranks):
    """tests/test_parallel.py:102: one sharded stage-0 step (with the alpha
    loss, gated on) gives the single-device step's loss, and, each rank's
    shard put together, its parameters, Adam moments and densification
    statistics (1e-3 normalised, the repo's gradient tolerance). The
    other stages' steps say they arrive with ROADMAP item 14b."""
    state, adam, stats, loss, _psnr, _lost = _single_device_step()
    for r in ranks:
        np.testing.assert_allclose(float(r["stage0/loss"]), float(loss), rtol=1e-6)
        for name in ("stage1", "stage21", "stage22", "eval_render"):
            assert bool(r[f"left_out/{name}"]), name
    want = {**{f"param/{k}": v for k, v in state.params().items()},
            **{f"mu/{k}": v for k, v in adam.mu.items()},
            **{f"nu/{k}": v for k, v in adam.nu.items()},
            **{f"stats/{f.name}": getattr(stats, f.name)
               for f in dataclasses.fields(stats)}}
    for key, w in want.items():
        got = np.concatenate([r[f"stage0/{key}"] for r in ranks]).astype(np.float64)
        assert_normalised(got, w.numpy().astype(np.float64), 1e-3, key)


def test_sharded_train_step_learns(ranks):
    """tests/test_parallel.py:72: 8 steps of make_sharded_train_step, the
    same losses on both ranks, finite, the last below the first."""
    a, b = (r["train/losses"] for r in ranks)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (wk.STEPS,) and np.isfinite(a).all() and a[-1] < a[0]


def test_scaling_bench_and_init(ranks, monkeypatch):
    """tests/test_parallel.py:380: scaling_bench over meshes of 1 and 2
    ranks reports both sizes on rank 0, size 2 on rank 1, with positive
    times and rank 0's size-1 efficiency 1; init_distributed does nothing
    in a single process, and the mesh and sharded render refuse to run
    without a process group."""
    rows0, rows1 = ranks[0]["scaling"], ranks[1]["scaling"]
    assert rows0[:, 0].tolist() == [1, 2] and rows1[:, 0].tolist() == [2]
    assert (rows0[:, 1] > 0).all() and np.isfinite(rows0[:, 2]).all()
    assert rows0[0, 3] == 1.0 and rows0[1, 1] == rows1[0, 1]
    for k in ("OPENGS_NUM_PROCESSES", "OPENGS_COORDINATOR", "OPENGS_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        mesh.make_mesh()
    with pytest.raises(TypeError, match="Mesh"):
        render.render_sharded(None, None, torch.zeros((4, 3)), None, None, None, None)


def test_shard_and_replicate():
    """shard_gaussians keeps this rank's contiguous rows of every leaf with
    a leading axis (0-d leaves and other values whole), through states,
    NamedTuples and dicts; replicate keeps everything."""
    m = mesh.Mesh(group=None, rank=1, size=2, device=torch.device("cpu"))
    state = G.create_from_pcd(*wk.toy_points()[:2], capacity=128, seed=0, device="cpu")
    adam = opt_mod.init(state.params())
    sh_state, sh_adam, scalar = mesh.shard_gaussians(m, (state, adam, torch.tensor(3.0)))
    assert sh_state.capacity == 64 and torch.equal(sh_state.means, state.means[64:])
    assert isinstance(sh_adam, opt_mod.AdamState) and sh_adam.count == 0
    assert torch.equal(sh_adam.mu["means"], adam.mu["means"][64:])
    assert float(scalar) == 3.0
    assert torch.equal(mesh.replicate(m, state).means, state.means)
    with pytest.raises(ValueError, match="split"):
        mesh.shard_gaussians(m, torch.zeros(5))
