"""Host-resident views in the port (train/loop.py:bundle_views(host=True),
bundle_window; save_memory and --lazy_load), mirroring the JAX package's
tests/test_trainer.py:190 and tests/test_lazy.py:53, 81.

On the CPU a host-resident run does the device-resident run's arithmetic on
the same views: its losses, state, codebooks, evaluation and dumps are equal
bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.config import Config, OptimizationConfig
from opengaussian_tpu_torch.data import dataset
from opengaussian_tpu_torch.data.lazy import LazyStack
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.train import observe
from opengaussian_tpu_torch.train.loop import Trainer, bundle_views, bundle_window
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

RCFG = RasterizeConfig(max_per_tile=128, chunk=32)
# stages 0 (densify at 3 and 6), 1 (the refiner before step 9), 2.1 and 2.2
OPT = OptimizationConfig(
    iterations=20, start_ins_feat_iter=8, start_root_cb_iter=12, start_leaf_cb_iter=16,
    densify_from_iter=2, densify_until_iter=7, densification_interval=3,
    opacity_reset_interval=1000, root_node_num=4, leaf_node_num=3, leaf_update_fr=2,
    sam_level=3, enable_multiview_sam_refinement=True)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_views") / "scene")
    make_colmap_scene(root, n_views=4)
    return root


def test_save_memory_matches_device_resident_bit_for_bit(scene_dir, tmp_path):
    """Through every stage, the refiner, evaluation, a dump and stage 3."""
    scene = dataset.load_scene(scene_dir, eval_split=True)
    runs = {}
    for save_memory in (False, True):
        cfg = Config(opt=dataclasses.replace(OPT, save_memory=save_memory))
        out = str(tmp_path / f"save_memory_{save_memory}")
        tr = Trainer(scene, cfg, out, rcfg=RCFG, seed=5, device="cpu")
        tr.train(log_every=100)
        observe.dump_intermediate(tr, tr.iteration, "2.2", 1)
        runs[save_memory] = (tr, tr.evaluate(), tr.run_stage3(), out)
    (a, ma, la, oa), (b, mb, lb, ob) = runs[False], runs[True]
    assert b.save_memory and not b.bundle.gt_images.is_cuda
    assert isinstance(b.pseudo.feat, torch.Tensor) and b.pseudo.feat.device.type == "cpu"
    assert torch.equal(torch.stack(a.losses), torch.stack(b.losses))
    assert len(a.losses) == OPT.iterations
    for f in dataclasses.fields(a.state):
        assert torch.equal(getattr(a.state, f.name), getattr(b.state, f.name)), f.name
    for f in dataclasses.fields(a.kms):
        assert torch.equal(getattr(a.kms, f.name), getattr(b.kms, f.name)), f.name
    assert torch.equal(a.bundle.sam_ids, b.bundle.sam_ids)
    assert a.bundle.max_masks == b.bundle.max_masks
    assert ma == mb and ma["views"] == b.test_bundle.num_views
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    dump = os.path.join("train_process", "renders", f"{OPT.iterations:05d}.png")
    with open(os.path.join(oa, dump), "rb") as fa, open(os.path.join(ob, dump), "rb") as fb:
        assert fa.read() == fb.read()


def test_bundle_windows_equal_their_slices(scene_dir):
    """Windows of the host bundle and of the lazy one equal the device
    bundle's slices; the lazy stacks materialize whole; a lazy scene needs
    a host bundle."""
    eager = dataset.load_scene(scene_dir)
    lazy = dataset.load_scene(scene_dir, lazy=True)
    dev = bundle_views(eager.train_views, 3, "cpu")
    host = bundle_views(eager.train_views, 3, "cpu", host=True)
    lz = bundle_views(lazy.train_views, 3, "cpu", host=True)
    assert isinstance(lz.gt_images, LazyStack) and isinstance(lz.sam_ids, LazyStack)
    assert dev.max_masks == host.max_masks == lz.max_masks
    assert dev.num_views == host.num_views == lz.num_views == 4
    fields = ("R", "t", "fx", "fy", "cx", "cy", "gt_images", "alpha_masks", "has_alpha",
              "sam_ids")
    for i in (0, 3):
        for b in (host, lz):
            w = bundle_window(b, i, "cpu")
            assert w.num_views == 1 and (w.width, w.height) == (dev.width, dev.height)
            for f in fields:
                assert torch.equal(getattr(w, f), getattr(dev, f)[i:i + 1]), f
    for f in ("gt_images", "alpha_masks", "sam_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(lz, f)), getattr(dev, f).numpy())
    with pytest.raises(ValueError):
        bundle_views(lazy.train_views, 3, "cpu")


def test_cli_lazy_load_equals_the_eager_run(scene_dir, tmp_path):
    """--lazy_load implies --save_memory and gives the eager run's losses,
    as does --save_memory alone; --mesh 2 in one process is refused."""
    argv = ["-s", scene_dir, "--iterations", "6", "--start_ins_feat_iter", "3",
            "--densify_from_iter", "1000"]
    runs = {name: tcli_train.main([*argv, "-m", str(tmp_path / name), *flags], device="cpu")
            for name, flags in (("eager", []), ("save_memory", ["--save_memory"]),
                                ("lazy", ["--lazy_load"]))}
    lazy = runs["lazy"]
    assert lazy.save_memory and isinstance(lazy.bundle.gt_images, LazyStack)
    assert runs["save_memory"].save_memory and not runs["eager"].save_memory
    want = torch.stack(runs["eager"].losses)
    for name in ("save_memory", "lazy"):
        assert torch.equal(torch.stack(runs[name].losses), want), name
    with pytest.raises(ValueError, match="a mesh of 2 devices in a world of 1"):
        tcli_train.main([*argv, "-m", str(tmp_path / "mesh"), "--mesh", "2"], device="cpu")
