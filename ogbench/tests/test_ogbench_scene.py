"""The benchmark's scene generators against the port's: the bench cloud's
law, the 3DGS scale initialisation (the k-nearest-neighbour distances), the
SAM levels' decoding and the cameras' mapping."""

import math

import numpy as np
import pytest
import torch

from ogbench import run, scene
from ogbench.tests.conftest import SMALL

SC = dict(run.load_cell("lerf-teatime.s0-train")["config"]["scene"], **SMALL)


def _splats(seed, sc=SC):
    return scene.make_splats(sc, torch.Generator().manual_seed(seed), "cpu")


def test_same_seed_same_scene_and_every_seed_the_same_sizes():
    a, b, c = _splats(3), _splats(3), _splats(4)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].shape == c[k].shape
    assert not torch.equal(a["means"], c["means"])
    assert a["means"].shape[0] == scene.capacity(SC["splats"]) and int(a["alive"].sum()) == 3000


def test_cloud_follows_the_bench_cloud():
    from opengaussian_tpu_torch.tools import bench

    n = 200_000
    want, _ = bench.workload_cloud(np.random.default_rng(0), n)
    got = _splats(0, dict(SC, splats=n))["means"][:n].numpy()
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.03)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.02)


@pytest.mark.parametrize("visible", [1.0, 0.6])
def test_scales_follow_the_knn_initialisation(visible):
    """The drawn mean squared 3-NN distance against the port's cKDTree one
    (models/gaussians.py:knn_mean_sq_dist) on clouds of the same law: the
    median and the quartiles of the log-scales within 6%."""
    from opengaussian_tpu_torch.models.gaussians import knn_mean_sq_dist

    n = 100_000
    sc = dict(SC, splats=n, visible_frac=visible, log_scale_spread=0.0, scale=1.0)
    sp = _splats(1, sc)
    pts = sp["means"][:n].numpy()
    want = 0.5 * np.log(np.maximum(knn_mean_sq_dist(pts), 1e-7))
    got = sp["log_scales"][:n, 0].numpy()
    inner = (np.abs(pts[:, 0]) < 2.4) & (np.abs(pts[:, 1]) < 1.8)  # away from the tails
    for q in (0.25, 0.5, 0.75):
        assert abs(np.quantile(got[inner], q) - np.quantile(want[inner], q)) < 0.06


def test_sam_levels_decode_through_the_port():
    from opengaussian_tpu_torch.utils.masks import decode_sam_level

    for i in (0, 7):
        ids = scene.make_sam_ids(SC, i)
        for level in (0, 3):
            got = decode_sam_level(scene.packed_sam(ids, level), level)
            np.testing.assert_array_equal(got, ids)
        assert ids.max() == 32 and (ids[:SC["mask_border"]] == 0).all()
    assert scene.max_masks(SC) == 32


def test_cameras_see_the_cloud_and_match_the_ports_mapping():
    from opengaussian_tpu_torch.cameras import Camera

    cams = scene.make_cameras(SC)
    for c in cams:
        cam = Camera.from_fov(c["R"], c["t"], SC["fovx"], SC["fovy"], SC["width"],
                              SC["height"])
        assert float(cam.fx) == pytest.approx(c["fx"], rel=1e-6)
        assert float(cam.cx) == c["cx"]
        centre = c["R"] @ np.array([0.0, 0.0, SC["orbit_radius"]]) + c["t"]
        np.testing.assert_allclose(centre, [0, 0, SC["orbit_radius"]], atol=1e-5)
    assert 0.5 < scene.cameras_extent(cams) < 5.0
    assert math.isclose(scene.cameras_extent(cams), scene.cameras_extent(scene.make_cameras(SC)))
