"""The port's evaluation and tool modules against the JAX package's: LPIPS
(on random weights: the pretrained lpips_vgg.npz is not in the
repository), the weight converter, evaluate_dirs and the metrics CLI, the
LeRF IoU, the ScanNet metrics, scannet2blender, full_eval, vis_pts_feat and
convert.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from opengaussian_tpu.cli import convert as jconvert
from opengaussian_tpu.cli import full_eval as jfull
from opengaussian_tpu.cli import scannet2blender as js2b
from opengaussian_tpu.cli import vis_pts_feat as jvis
from opengaussian_tpu.eval import lerf_iou as jlerf
from opengaussian_tpu.eval import lpips as jlpips
from opengaussian_tpu.eval import metrics as jmetrics
from opengaussian_tpu.eval import scannet as jscan
from opengaussian_tpu_torch.cli import convert as tconvert
from opengaussian_tpu_torch.cli import full_eval as tfull
from opengaussian_tpu_torch.cli import scannet2blender as ts2b
from opengaussian_tpu_torch.cli import vis_pts_feat as tvis
from opengaussian_tpu_torch.data.ply import read_ply, save_gaussian_ply, write_ply
from opengaussian_tpu_torch.eval import lerf_iou as tlerf
from opengaussian_tpu_torch.eval import lpips as tlpips
from opengaussian_tpu_torch.eval import metrics as tmetrics
from opengaussian_tpu_torch.eval import scannet as tscan
from opengaussian_tpu_torch.models import gaussians as TG
from tests.test_torch_render import random_state_arrays

torch.set_num_threads(1)


def image_pair(h=33, w=47, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_random_weights_equal_jax():
    got, want = tlpips.random_weights(seed=3), jlpips.random_weights(seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tlpips.WEIGHTS_ENV == jlpips.WEIGHTS_ENV
    assert tlpips.DEFAULT_WEIGHTS_PATH == jlpips.DEFAULT_WEIGHTS_PATH


@pytest.mark.parametrize("shape", [(33, 47), (32, 32), (40, 64)])
def test_lpips_matches_jax(shape):
    w = jlpips.random_weights(seed=3)
    a, b = image_pair(*shape)
    t, j = tlpips.LPIPS(w, device="cpu"), jlpips.LPIPS(w)
    assert t(a, b) == pytest.approx(j(a, b), rel=1e-4)
    assert t(a, a) == pytest.approx(0.0, abs=1e-6)
    assert t(torch.as_tensor(b), torch.as_tensor(a)) == pytest.approx(t(a, b), rel=1e-5)


def synthetic_torch_states(seed=2):
    """torchvision-layout VGG16 features and richzhang lin state dicts, as
    torch tensors (tests/test_lpips.py's layout)."""
    rng = np.random.default_rng(seed)
    vgg, lin = {}, {}
    idx, cin = 0, 3
    for i, cout in enumerate(tlpips.VGG16_CHANNELS):
        if i in tlpips.POOL_BEFORE:
            idx += 1
        vgg[f"{idx}.weight"] = torch.tensor(rng.normal(0, 0.1, (cout, cin, 3, 3)),
                                            dtype=torch.float32)
        vgg[f"{idx}.bias"] = torch.tensor(rng.normal(0, 0.1, cout), dtype=torch.float32)
        idx += 2
        cin = cout
    for i, c in enumerate(tlpips.N_CHANNELS_LIST):
        lin[f"{i}.1.weight"] = torch.tensor(rng.uniform(0, 0.1, (1, c, 1, 1)),
                                            dtype=torch.float32)
    return vgg, lin


def test_converted_weights_load_alike_in_both(tmp_path):
    vgg, lin = synthetic_torch_states()
    tpath, jpath = str(tmp_path / "t" / "lpips_vgg.npz"), str(tmp_path / "j.npz")
    tlpips.convert_torch_weights(vgg, lin, tpath)
    jlpips.convert_torch_weights({k: v.numpy() for k, v in vgg.items()},
                                 {k: v.numpy() for k, v in lin.items()}, jpath)
    wt, wj = tlpips.load_weights(tpath), jlpips.load_weights(tpath)
    w_jax_file = jlpips.load_weights(jpath)
    assert sorted(wt) == sorted(wj) == sorted(w_jax_file)
    for k in wt:
        np.testing.assert_array_equal(wt[k], wj[k])
        np.testing.assert_array_equal(wt[k], w_jax_file[k])
    assert wt["conv2_w"].shape == (3, 3, 64, 128)
    np.testing.assert_array_equal(wt["conv2_w"], vgg["5.weight"].numpy().transpose(2, 3, 1, 0))
    # the net reads the HWIO file as torch's OIHW
    tw = tlpips.torch_weights(wt, "cpu")
    assert torch.equal(tw["conv2_w"], vgg["5.weight"])
    a, b = image_pair(24, 24, seed=4)
    assert tlpips.LPIPS(wt, "cpu")(a, b) == pytest.approx(jlpips.LPIPS(wj)(a, b), rel=1e-4)


def test_lpips_without_weights_warns_and_returns_none(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tlpips.WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    monkeypatch.setattr(tlpips, "_INSTANCES", {})
    assert tlpips.weights_path() is None
    assert tlpips.get_lpips("cpu") is None
    assert "WARNING: no weights found" in capsys.readouterr().err
    assert tlpips.get_lpips("cpu") is None
    assert capsys.readouterr().err == ""  # warned once
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlpips.get_lpips()


def write_image_dirs(root, n=3, h=30, w=40, seed=5):
    rng = np.random.default_rng(seed)
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        gt = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        rd = np.clip(gt.astype(int) + rng.integers(-20, 21, gt.shape), 0, 255).astype(np.uint8)
        Image.fromarray(gt).save(os.path.join(root, "gt", f"{i:05d}.png"))
        Image.fromarray(rd).save(os.path.join(root, "renders", f"{i:05d}.png"))


@pytest.mark.parametrize("with_weights", [False, True])
def test_evaluate_dirs_matches_jax(tmp_path, monkeypatch, with_weights):
    d = str(tmp_path / "imgs")
    write_image_dirs(d)
    wpath = tmp_path / "lpips_vgg.npz"
    if with_weights:
        np.savez(wpath, **jlpips.random_weights(seed=1))
    monkeypatch.setenv(jlpips.WEIGHTS_ENV, str(wpath))
    monkeypatch.setattr(jlpips, "_INSTANCE", None)  # the JAX package caches one LPIPS
    got = tmetrics.evaluate_dirs(os.path.join(d, "renders"), os.path.join(d, "gt"), "cpu")
    want = jmetrics.evaluate_dirs(os.path.join(d, "renders"), os.path.join(d, "gt"))
    for m in ("PSNR", "SSIM", "LPIPS"):
        assert sorted(got["per_view"][m]) == sorted(want["per_view"][m])
        for name, v in want["per_view"][m].items():
            assert got["per_view"][m][name] == pytest.approx(v, rel=1e-5 if m != "LPIPS" else 1e-4)
    assert (got["results"]["LPIPS"] is None) == (not with_weights)
    assert len(got["per_view"]["PSNR"]) == 3


def test_metrics_cli_writes_results_json_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(jlpips.WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    monkeypatch.setattr(jlpips, "_INSTANCE", None)
    for pkg in ("jax", "torch"):
        write_image_dirs(str(tmp_path / pkg / "test" / "ours_7"))
    jmetrics.main(["-m", str(tmp_path / "jax")])
    tmetrics.main(["-m", str(tmp_path / "torch")], device="cpu")
    want = json.load(open(tmp_path / "jax" / "results.json"))
    got = json.load(open(tmp_path / "torch" / "results.json"))
    assert list(got) == list(want) == ["ours_7"]
    assert got["ours_7"]["LPIPS"] is None and want["ours_7"]["LPIPS"] is None
    for m in ("PSNR", "SSIM"):
        assert got["ours_7"][m] == pytest.approx(want["ours_7"][m], rel=1e-5)


def test_lerf_iou_equals_jax(tmp_path):
    """tests/test_eval_tools.py's half-overlap fixture, a second object with
    no prediction (IoU 0) and a second frame."""
    gt_base, pred_base = tmp_path / "gt", tmp_path / "pred"
    os.makedirs(pred_base)
    rng = np.random.default_rng(6)
    for frame in ("frame_00002", "frame_00025"):
        os.makedirs(gt_base / frame)
        for obj in ("apple", "sheep"):
            m = np.zeros((20, 20), np.uint8)
            m[5:15, 5:15] = 255
            Image.fromarray(m).save(gt_base / frame / f"{obj}.jpg")
        p = (rng.random((20, 20)) < 0.4).astype(np.uint8) * 255
        p[5:15, 5:10] = 255
        Image.fromarray(p).save(pred_base / f"{frame}_apple.png")
    got = tlerf.evaluate(str(gt_base), str(pred_base), "teatime")
    want = jlerf.evaluate(str(gt_base), str(pred_base), "teatime")
    assert got == want and got["n"] == 4
    assert got["per_object"]["frame_00002/sheep"] == 0.0
    assert tlerf.SCENE_EVAL_FRAMES == jlerf.SCENE_EVAL_FRAMES


def test_scannet_metrics_equal_jax():
    rng = np.random.default_rng(7)
    cases = [(np.array([0, 1, 1, 2, 2, 2, 3]), np.array([1, 1, 2, 2, 2, 2, 1]), 4)]
    cases += [(rng.integers(0, 20, 500), rng.integers(1, 20, 500), 20) for _ in range(3)]
    for gt, pred, total in cases:
        got, want = tscan.calculate_metrics(gt, pred, total), jscan.calculate_metrics(gt, pred,
                                                                                       total)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    n_leaf, n_cls = 12, 3
    text = rng.normal(size=(n_cls, 512)).astype(np.float32)
    lang = dict(leaf_feat=(text[np.arange(n_leaf) % n_cls]
                           + rng.normal(0, 0.5, (n_leaf, 512))).astype(np.float32),
                occu_count=rng.integers(0, 5, n_leaf).astype(np.float32),
                leaf_ind=rng.integers(0, n_leaf + 1, 300))
    np.testing.assert_array_equal(tscan.predict_point_classes(lang, text, n_leaf),
                                  jscan.predict_point_classes(lang, text, n_leaf))


def test_scannet_evaluate_scene_equals_jax(tmp_path):
    """evaluate_scene on a model directory (PLY, cluster_lang.npz), GT labels
    and a text-feature file, through the port's read_ply and find_iteration."""
    rng = np.random.default_rng(8)
    arrays = random_state_arrays(n=300, cap=300, seed=9)
    pc = tmp_path / "model" / "point_cloud" / "iteration_12"
    pc.mkdir(parents=True)
    save_gaussian_ply(str(pc / "point_cloud.ply"), TG.state_from_numpy(arrays, "cpu"))
    n_leaf = 10
    np.savez(tmp_path / "model" / "cluster_lang.npz",
             leaf_feat=rng.normal(size=(n_leaf, 512)).astype(np.float32),
             leaf_score=rng.uniform(size=n_leaf).astype(np.float32),
             occu_count=rng.integers(0, 6, n_leaf).astype(np.float32),
             leaf_ind=rng.integers(0, n_leaf, 300))
    labels = tmp_path / "scene_vh_clean_2.labels.ply"
    write_ply(str(labels), dict(x=rng.normal(size=300), y=rng.normal(size=300),
                                z=rng.normal(size=300),
                                label=rng.integers(0, 41, 300).astype(np.float32)))
    tf = tmp_path / "text.json"
    json.dump({name: rng.normal(size=512).tolist() for name in tscan.NYU40.values()},
              open(tf, "w"))
    for subset in (19, 10):
        args = (str(tmp_path / "model"), str(labels), str(tf), subset)
        got, want = tscan.evaluate_scene(*args), jscan.evaluate_scene(*args)
        assert got == want
        assert np.isfinite(got["acc"]) and len(got["per_class_iou"]) == subset


def test_scannet2blender_equals_jax(tmp_path):
    for pkg in ("jax", "torch"):
        scan = tmp_path / pkg
        os.makedirs(scan / "pose")
        os.makedirs(scan / "intrinsic")
        np.savetxt(scan / "intrinsic" / "intrinsic_color.txt", np.eye(4) * 1000)
        rng = np.random.default_rng(10)
        for i in range(4):
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3)
            np.savetxt(scan / "pose" / f"{i}.txt", c2w)
        np.savetxt(scan / "pose" / "4.txt", np.full((4, 4), -np.inf))
    want = json.load(open(js2b.convert(str(tmp_path / "jax"))))
    got = json.load(open(ts2b.convert(str(tmp_path / "torch"))))
    assert got == want and len(got["frames"]) == 4


def test_full_eval_scene_tables_and_skip(tmp_path, capsys, monkeypatch):
    """tests/test_eval_tools.py:96-137 against the port's full_eval, and its
    metrics-only run over an evaluated scene against the JAX one's."""
    for name in ("MIPNERF360_OUTDOOR", "MIPNERF360_INDOOR", "TANKS_AND_TEMPLES",
                 "DEEP_BLENDING", "ALL_SCENES"):
        assert getattr(tfull, name) == getattr(jfull, name)
    assert len(tfull.ALL_SCENES) == 13

    class A:
        mipnerf360, tanksandtemples, deepblending = "/m", "/t", "/d"

    assert tfull.scene_sources(A) == jfull.scene_sources(A)
    tfull.main(["--skip_training", "--skip_rendering", "--output_path",
                str(tmp_path / "none")], device="cpu")
    assert "no evaluated scenes" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the dataset roots are required to train
        tfull.main(["--output_path", str(tmp_path / "none")], device="cpu")

    monkeypatch.setenv(jlpips.WEIGHTS_ENV, str(tmp_path / "missing.npz"))
    monkeypatch.setattr(jlpips, "_INSTANCE", None)
    for pkg in ("jax", "torch"):
        write_image_dirs(str(tmp_path / pkg / "bicycle" / "test" / "ours_3"), seed=11)
    args = ["--skip_training", "--skip_rendering", "--output_path"]
    jfull.main(args + [str(tmp_path / "jax")])
    tfull.main(args + [str(tmp_path / "torch")], device="cpu")
    want = json.load(open(tmp_path / "jax" / "bicycle" / "results.json"))
    got = json.load(open(tmp_path / "torch" / "bicycle" / "results.json"))
    assert got.keys() == want.keys()
    assert got["ours_3"]["PSNR"] == pytest.approx(want["ours_3"]["PSNR"], rel=1e-5)


def test_vis_pts_feat_equals_jax(tmp_path):
    arrays = random_state_arrays(n=200, cap=200, seed=12)
    ply = str(tmp_path / "point_cloud.ply")
    save_gaussian_ply(ply, TG.state_from_numpy(arrays, "cpu"))
    feat = arrays["ins_feat"]
    np.testing.assert_array_equal(tvis.feature_colors(feat), jvis.feature_colors(feat))
    jvis.main(["--ply", ply, "--out", str(tmp_path / "j.ply")])
    tvis.main(["--ply", ply, "--out", str(tmp_path / "t.ply")])
    got, want = read_ply(str(tmp_path / "t.ply")), read_ply(str(tmp_path / "j.ply"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_convert_refuses_without_colmap_like_jax(tmp_path):
    args = ["-s", str(tmp_path), "--colmap_executable", "no-such-colmap-binary"]
    with pytest.raises(SystemExit) as t:
        tconvert.main(args)
    with pytest.raises(SystemExit) as j:
        jconvert.main(args)
    assert str(t.value) == str(j.value) and "colmap not found" in str(t.value)
