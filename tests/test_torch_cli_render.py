"""The port's render CLI against the JAX package's, end to end.

A COLMAP scene from tests/test_data.py:make_colmap_scene and one model
directory whose PLY is written by the JAX package's `save_gaussian_ply`;
both CLIs' `main` render it (the port's on the CPU, through main's `device`
argument) and their PNGs must agree within 1 LSB on at least 99.9% of the
pixels. The JAX CLI renders through its XLA blend on the CPU, the port
through its plain blend.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from opengaussian_tpu.cli import render as jcli
from opengaussian_tpu.data.ply import save_gaussian_ply
from opengaussian_tpu.models.gaussians import GaussianState as JState
from opengaussian_tpu_torch.cli import render as tcli
from tests.test_data import make_colmap_scene
from tests.test_torch_render import random_state_arrays

torch.set_num_threads(1)

SUBDIRS = ("renders", "gt", "ins_feat1", "ins_feat2", "sam_mask")


def test_cli_render_matches_jax(tmp_path):
    scene = str(tmp_path / "scene")
    make_colmap_scene(scene, n_views=3)
    arrays = random_state_arrays(n=400, seed=5)
    arrays["means"][:400] = np.random.default_rng(6).normal(0, 0.7, (400, 3))
    pc = tmp_path / "model_jax" / "point_cloud" / "iteration_7"
    pc.mkdir(parents=True)
    save_gaussian_ply(str(pc / "point_cloud.ply"),
                      JState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    shutil.copytree(tmp_path / "model_jax", tmp_path / "model_torch")

    jcli.main(["-m", str(tmp_path / "model_jax"), "-s", scene])
    n = tcli.main(["-m", str(tmp_path / "model_torch"), "-s", scene], device="cpu")
    assert n == 3  # llffhold=8: two train views, one test view

    compared = 0
    for split in ("train", "test"):
        for sub in SUBDIRS:
            dj = tmp_path / "model_jax" / split / "ours" / sub
            dt = tmp_path / "model_torch" / split / "ours" / sub
            names = sorted(os.listdir(dj))
            assert names and sorted(os.listdir(dt)) == names, (split, sub)
            for name in names:
                a = np.asarray(Image.open(dj / name), np.int16)
                b = np.asarray(Image.open(dt / name), np.int16)
                assert a.shape == b.shape == (48, 64, 3)
                close = np.abs(a - b) <= 1
                assert close.mean() >= 0.999, (split, sub, name, close.mean())
                compared += 1
    assert compared == 3 * len(SUBDIRS)
    img = np.asarray(Image.open(tmp_path / "model_torch/train/ours/renders/00000.png"))
    assert img.max() > 0  # the splats are in view
