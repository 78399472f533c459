"""The budget probe where its pool overflows, in both packages.

`ops/budget.py:probe` bins each sampled view into a pool of
`PROBE_MULTIPLE * N` slots. A view with more intersections than that drops
the excess before its tiles are counted, so the probe reads a shallower
deepest tile than the view has, and a trainer at the tuned budgets loses
slots in its first steps. Both packages do this; here a small scene whose
views overflow the pool (about 3,500 intersections against a pool of 2,000)
holds the port's probe, `tuned_config` and the default trainer's first-step
lost count against the JAX package's. CPU, 3 views at 160x120, 200 splats.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from opengaussian_tpu.cameras import Camera as JCamera
from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops import budget as jbudget
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import colmap
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import budget
from opengaussian_tpu_torch.ops.binning import bin_gaussians
from opengaussian_tpu_torch.ops.projection import build_cov3d, project
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import loop as tloop

W, H, N, VIEWS = 160, 120, 200, 3
BASE = dict(max_per_tile=128, chunk=32, min_intersections=4096)
BUDGETS = ("intersection_budget", "max_per_tile")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide_scene(root: str) -> None:
    """A COLMAP scene of VIEWS views whose N points lie sparse in front of
    the cameras: their nearest-neighbour scales make each splat cover about
    18 of the 80 tiles, so a view has about 3,500 intersections, past the
    probe's pool of PROBE_MULTIPLE * N = 2,000."""
    os.makedirs(os.path.join(root, "sparse/0"))
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(0)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([150.0, 150.0, W / 2, H / 2]))}
    imgs = {}
    for i in range(VIEWS):
        ang = 0.1 * (i - 1)
        q = np.array([np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0])
        imgs[i + 1] = colmap.ColmapImage(i + 1, q, np.array([0.0, 0.0, 4.0]), 1,
                                         f"img_{i:03d}.png")
        Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"img_{i:03d}.png"))
    colmap.write_cameras_binary(cams, os.path.join(root, "sparse/0/cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(root, "sparse/0/images.bin"))
    xyz = np.stack([rng.uniform(-1, 1, N), rng.uniform(-0.75, 0.75, N),
                    rng.uniform(-1.5, -0.5, N)], -1)
    colmap.write_points3d_binary(xyz, (rng.random((N, 3)) * 255).astype(np.uint8),
                                 os.path.join(root, "sparse/0/points3D.bin"))


@pytest.fixture
def scene_dir(tmp_path):
    root = str(tmp_path / "scene")
    wide_scene(root)
    return root


@pytest.fixture
def exact_capacity(monkeypatch):
    """Capacities rounded to 8 slots in both packages, so that N = 200 and
    the probe's pool is 2,000 slots."""
    for mod in (TG, JG):
        monkeypatch.setattr(mod, "round_capacity",
                            lambda n, multiple=8, _f=mod.round_capacity: _f(n, multiple))


def states(scene_dir):
    scene = tdataset.load_scene(scene_dir)
    jst = JG.create_from_pcd(scene.points, scene.colors, capacity=N, seed=0)
    tst = TG.create_from_pcd(scene.points, scene.colors, capacity=N, seed=0, device="cpu")
    jcams = [JCamera(R_w2c=v.camera.R_w2c.numpy(), t_w2c=v.camera.t_w2c.numpy(),
                     fx=float(v.camera.fx), fy=float(v.camera.fy), cx=float(v.camera.cx),
                     cy=float(v.camera.cy), width=W, height=H) for v in scene.train_views]
    return jst, tst, jcams, [v.camera for v in scene.train_views]


@pytest.mark.parametrize("headroom", [1.3, 1.05])
def test_overflowing_probe_matches_jax(scene_dir, headroom):
    """Every view overflows the pool, so the probe reads a shallower deepest
    tile than the whole binning has, in both packages alike: the same probe
    and the same tuned P and K, which truncate."""
    jst, tst, jcams, tcams = states(scene_dir)
    cov3d = build_cov3d(tst.scales, tst.quats)
    deepest = []
    for cam in tcams:
        proj = project(tst.means, cov3d, cam, opacities=tst.opacity)
        bins = bin_gaussians(proj, W // 16, H // 16, 1 << 20)
        assert int(bins.total) > budget.PROBE_MULTIPLE * N
        deepest.append(int(bins.deepest))
    probed = budget.probe(tst, tcams)
    assert probed == jbudget.probe(jst, jcams)
    assert probed[1] < max(deepest)  # the pool undercounts the deepest tile
    tt = budget.tuned_config(TRaster(**BASE), tst, tcams, headroom=headroom)
    jt = jbudget.tuned_config(JRaster(**BASE), jst, jcams, headroom=headroom)
    assert tuple(getattr(tt, k) for k in BUDGETS) == tuple(getattr(jt, k) for k in BUDGETS)
    assert tt.max_per_tile < max(deepest)


def lost_in(out: str, it: int) -> int:
    """The slots a trainer's logged step `it` lost, from its budget warning
    (both trainers print one and re-probe when a logged step lost slots);
    0 without a warning."""
    m = re.search(rf"\[budget\] WARNING: step {it} lost (\d+) intersections", out)
    return int(m.group(1)) if m else 0


def test_first_steps_lose_as_jax(scene_dir, tmp_path, exact_capacity, capsys):
    """Both trainers at their defaults probe the overflowing views alike and
    lose the same slots in each of their first stage-0 steps (truncated
    tiles), with the same budgets, and re-probe alike after each logged step
    that lost slots."""
    opt = dict(iterations=3, densify_until_iter=0)
    jtr = jloop.Trainer(jdataset.load_scene(scene_dir), JConfig(opt=JOpt(**opt)),
                        str(tmp_path / "jax"), rcfg=JRaster(**BASE, backend="xla"), seed=3)
    ttr = tloop.Trainer(tdataset.load_scene(scene_dir), TConfig(opt=TOpt(**opt)),
                        str(tmp_path / "port"), rcfg=TRaster(**BASE), seed=3, device="cpu")
    jtr.save_intermediate = ttr.save_intermediate = False
    assert ttr.state.capacity == jtr.state.capacity == N
    lost = []
    for it in range(1, opt["iterations"] + 1):
        capsys.readouterr()
        jtr.train(until=it, log_every=10_000)
        j_out = capsys.readouterr().out
        ttr.train(until=it, log_every=10_000)
        t_out = capsys.readouterr().out
        assert tuple(getattr(ttr.rcfg, k) for k in BUDGETS) == tuple(
            getattr(jtr.rcfg, k) for k in BUDGETS), it
        lost.append(lost_in(t_out, it))
        assert lost[-1] == lost_in(j_out, it), (it, t_out, j_out)
    assert lost[0] > 0  # the first step truncates
