"""The port's stage-0 trainer (train/loop.py, cli/train.py) against the JAX
package's.

The JAX side runs its Pallas stream kernels in interpret mode
(backend="pallas"), with budgets large enough that no slot is dropped or
truncated; the port runs the plain versions of K1, K2 and K3 on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.models import optimizer as jopt
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu_torch.cli import render as tcli_render
from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import loop as tloop
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

JCFG = JRaster(max_per_tile=256, chunk=32, min_intersections=16384, backend="pallas")
TCFG = TRaster(max_per_tile=256, chunk=32)
FIELDS = JG.PARAM_FIELDS


def toy_training_state(n=64, cap=128, seed=2):
    """tests/test_parallel.py:_toy_training_state (JAX package)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.uniform(2.5, 5, n)], -1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    state = JG.create_from_pcd(pts, cols, capacity=cap)
    return state, jopt.init(state.params()), JG.DensifyStats.zeros(cap)


def normalised_close(got: torch.Tensor, want, atol, name):
    g, w = got.detach().numpy(), np.asarray(want)
    assert np.isfinite(g).all(), f"{name}: not finite"
    scale = max(float(np.abs(w).max()), 1e-12)
    np.testing.assert_allclose(g / scale, w / scale, atol=atol, err_msg=name)


def test_stage0_step_matches_jax():
    """One step on tests/test_parallel.py:127-138's 64x48 bundle."""
    state, adam, stats = toy_training_state()
    cam = JCamera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48)
    gt = np.random.default_rng(0).uniform(0.2, 0.8, (48, 64, 3)).astype(np.float32)
    # the port's inputs, before the JAX step (which donates its own)
    t_state = TG.state_from_numpy({k: np.asarray(getattr(state, k))
                                   for k in FIELDS + ("alive",)}, device="cpu")
    t_adam = TG.adam_from_numpy({k: np.asarray(v) for k, v in adam.mu.items()},
                                {k: np.asarray(v) for k, v in adam.nu.items()},
                                int(adam.count), device="cpu")
    t_stats = TG.stats_from_numpy(np.asarray(stats.grad_accum), np.asarray(stats.denom),
                                  np.asarray(stats.max_radii2d), device="cpu")
    bundle = jloop.ViewBundle(
        R=cam.R_w2c[None], t=cam.t_w2c[None],
        fx=jnp.asarray([cam.fx]), fy=jnp.asarray([cam.fy]),
        cx=jnp.asarray([cam.cx]), cy=jnp.asarray([cam.cy]),
        gt_images=jnp.asarray(gt)[None], alpha_masks=jnp.ones((1, 48, 64)),
        has_alpha=jnp.asarray([False]), sam_ids=jnp.zeros((1, 48, 64), jnp.int32),
        width=64, height=48, max_masks=8)
    j_state, j_adam, j_stats, j_loss, j_psnr, j_lost = jloop.stage0_step(
        state, adam, stats, bundle, jnp.int32(0), jnp.int32(1), jnp.zeros(3),
        1.0, JCFG, JOpt())

    t_bundle = tloop.ViewBundle(
        R=torch.tensor(np.asarray(cam.R_w2c))[None], t=torch.tensor(np.asarray(cam.t_w2c))[None],
        fx=torch.tensor([float(cam.fx)]), fy=torch.tensor([float(cam.fy)]),
        cx=torch.tensor([float(cam.cx)]), cy=torch.tensor([float(cam.cy)]),
        gt_images=torch.tensor(gt)[None], alpha_masks=torch.ones((1, 48, 64)),
        has_alpha=torch.tensor([False]), sam_ids=torch.zeros((1, 48, 64), dtype=torch.int32),
        width=64, height=48, max_masks=8)
    s2, a2, st2, loss, psnr, lost = tloop.stage0_step(
        t_state, t_adam, t_stats, t_bundle, 0, 1, torch.zeros(3), 1.0, TCFG, TOpt())

    assert int(lost) == int(j_lost) == 0
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(float(psnr), float(j_psnr), rtol=1e-4)
    assert a2.count == int(j_adam.count) == 1
    for k in FIELDS:
        normalised_close(getattr(s2, k), getattr(j_state, k), 1e-3, f"param {k}")
        normalised_close(a2.mu[k], j_adam.mu[k], 1e-3, f"mu {k}")
        normalised_close(a2.nu[k], j_adam.nu[k], 1e-3, f"nu {k}")
    np.testing.assert_array_equal(st2.denom.numpy(), np.asarray(j_stats.denom))
    np.testing.assert_array_equal(st2.max_radii2d.numpy(), np.asarray(j_stats.max_radii2d))
    np.testing.assert_allclose(st2.grad_accum.numpy(), np.asarray(j_stats.grad_accum),
                               atol=1e-5)
    assert float(st2.denom.max()) > 0 and float(st2.grad_accum.max()) > 0
    # the parameters the color pass reads moved (quats do not: the splats
    # start isotropic, so a rotation changes nothing)
    for k in ("means", "sh_dc", "log_scales", "logit_opacity"):
        assert float((getattr(s2, k) - getattr(t_state, k)).abs().max()) > 0, k


def test_trainer_matches_jax(tmp_path, capsys):
    """20 steps on make_colmap_scene with a densify event at steps 10 and 20.
    Both trainers visit the same views (np.random.default_rng(seed)); their
    losses agree through step 10. The split children of the event at step 10
    are offset by each package's own random draws, so from step 11 the runs
    differ by those draws (by a few percent in loss and a few splats after
    the event at step 20): the final PSNR agrees within 0.5 dB. The JAX
    budgets hold every slot of the grown scene, as the port's per-frame
    binning does."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4, with_sidecars=False)
    opt = dict(iterations=20, densify_from_iter=5, densification_interval=10,
               densify_grad_threshold=1e-5)
    jcfg = JRaster(max_per_tile=1024, chunk=32, min_intersections=131072, backend="pallas")
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"), rcfg=jcfg, autotune_budgets=False)
    jtr.save_intermediate = False
    ttr = tloop.Trainer(tdataset.load_scene(root), TConfig(opt=TOpt(**opt)),
                        str(tmp_path / "torch"), rcfg=TRaster(max_per_tile=1024, chunk=32),
                        device="cpu")
    n0 = int(ttr.state.num_alive)
    assert n0 == int(jtr.state.num_alive) == 200
    for until in (10, 20):
        jtr.train(until=until, log_every=1)
        ttr.train(until=until, log_every=1)
        if until == 10:
            assert int(ttr.state.num_alive) == int(jtr.state.num_alive) > n0
    j_loss = [r["loss"] for r in jtr.history]
    t_loss = [r["loss"] for r in ttr.history]
    assert len(t_loss) == len(ttr.losses) == 20
    np.testing.assert_allclose(t_loss[:10], j_loss[:10], rtol=1e-4)
    assert np.isfinite(t_loss).all()
    assert "lost" not in capsys.readouterr().out  # neither trainer lost a slot
    jm, tm = jtr.evaluate(), ttr.evaluate()
    assert tm["views"] == jm["views"] == 4
    assert abs(tm["psnr"] - jm["psnr"]) < 0.5, (tm, jm)


def test_cli_train_writes_a_ply_that_cli_render_renders(tmp_path):
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3)
    out = str(tmp_path / "model")
    tr = tcli_train.main(["-s", root, "-m", out, "--iterations", "4",
                          "--densify_from_iter", "1", "--densification_interval", "2",
                          "--densify_grad_threshold", "1e-6"], device="cpu")
    assert tr.iteration == 4 and len(tr.losses) == 4
    assert int(tr.state.num_alive) > 200  # the densify events at 2 and 4 grew it
    assert os.path.exists(os.path.join(out, "point_cloud/iteration_4/point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "cfg_args.json"))
    assert tcli_render.main(["-m", out, "-s", root], device="cpu") == 3
    assert os.path.exists(os.path.join(out, "train/ours/renders/00000.png"))


@pytest.mark.parametrize("flags", [["--mesh", "2"]])
def test_cli_train_refuses_what_the_port_lacks(tmp_path, flags):
    with pytest.raises(NotImplementedError):
        tcli_train.main(["-s", str(tmp_path), "-m", str(tmp_path / "m"), *flags],
                        device="cpu")


def test_cli_train_port_starts_the_viewer(tmp_path):
    """--port N trains and leaves the SIBR viewer listening on N (the
    round trip itself: tests/test_torch_observe.py)."""
    import socket

    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=2, with_sidecars=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tr = tcli_train.main(["-s", root, "-m", str(tmp_path / "m"), "--iterations", "2",
                          "-r", "2", "--port", str(port)], device="cpu")
    try:
        assert tr.iteration == 2 and tr.viewer_port == port and tr.viewer is not None
        with socket.create_connection(("127.0.0.1", port), timeout=10):
            pass  # the listener takes the connection
    finally:
        tr.viewer.close()


def test_trainer_never_truncates_a_tile(tmp_path):
    """A max_per_tile below the deepest tile truncated slots in every step
    (the JAX trainer's budget probe grows the cap instead): the trainer
    raises it before the first step, and its steps then equal those of a
    trainer whose cap was large enough from the start."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=3, with_sidecars=False)
    cfg = TConfig(opt=TOpt(iterations=3))
    trs = [tloop.Trainer(tdataset.load_scene(root), cfg, str(tmp_path / f"out{k}"),
                         rcfg=TRaster(max_per_tile=k, chunk=32), device="cpu")
           for k in (32, 1024)]
    for tr in trs:
        tr.train(until=3, log_every=1)
    small, big = trs
    assert 32 < small.rcfg.max_per_tile < 1024 and big.rcfg.max_per_tile == 1024
    assert int(small._last_lost) == 0
    assert [r["loss"] for r in small.history] == [r["loss"] for r in big.history]
