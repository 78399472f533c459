"""The port's selection path against the JAX package's: the KNN outlier
mask (ops/knn.py), the leaf choices of the text and click queries,
render_selection (render/__init__.py), and both query CLIs end to end.

render_selection's JAX side runs its Pallas stream kernel in interpret mode
(backend="pallas", tile_windows=0), with budgets that drop and truncate
nothing; the port runs K1's plain version on the CPU. The CLIs run on a
model directory written as training writes one (PLY, root and leaf
codebooks, cluster_lang.npz, and the feature maps of cli.render), so both
packages load the same files.
"""

import json
import os
import re
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opengaussian_tpu.cli import render_by_click as jclick
from opengaussian_tpu.cli import render_by_text as jtext
from opengaussian_tpu.data.ply import save_gaussian_ply
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops import knn as jknn
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JConfig
from opengaussian_tpu.render import render_selection as j_render_selection
from opengaussian_tpu.utils.codebook import save_codebook
from opengaussian_tpu_torch import cameras as tcam
from opengaussian_tpu_torch.cli import render as tcli_render
from opengaussian_tpu_torch.cli import render_by_click as tclick
from opengaussian_tpu_torch.cli import render_by_text as ttext
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops import knn as tknn
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig
from opengaussian_tpu_torch.render import render_selection
from tests.test_data import make_colmap_scene
from tests.test_rasterize import make_cam

torch.set_num_threads(1)

W, H = 64, 48
TOL = dict(atol=3e-5, rtol=1e-4)
PALLAS = JConfig(max_per_tile=256, chunk=32, min_intersections=16384, backend="pallas",
                 tile_windows=0)
TCFG = RasterizeConfig(max_per_tile=256, chunk=32)
K1, K2 = 3, 2  # roots and leaves per root of the CLI fixture


@pytest.mark.parametrize("n,seed,outliers", [(200, 3, 5), (57, 4, 0), (1000, 5, 20), (12, 6, 1)])
def test_outlier_mask_matches_jax(n, seed, outliers):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    pts[:outliers] += 10.0
    got = tknn.statistical_outlier_mask(pts)
    np.testing.assert_array_equal(got, jknn.statistical_outlier_mask(pts))
    np.testing.assert_array_equal(tknn.knn_mean_dists(pts, 7), jknn.knn_mean_dists(pts, 7))
    if outliers:
        assert not got[:outliers].any()


def text_cases():
    """tests/test_eval_tools.py's seeded top-k case, then random tables with
    cold leaves (occu_count < MIN_OCCU) and near codebook features."""
    rng = np.random.default_rng(1)
    k1, k2 = 4, 3
    lang = dict(leaf_feat=rng.normal(size=(k1 * k2, 512)).astype(np.float32),
                occu_count=np.full(k1 * k2, 10.0))
    text = lang["leaf_feat"][7].copy()
    centers = rng.normal(size=(k1 * k2 + 1, 6)).astype(np.float32)
    centers[8] = centers[7] + 0.01
    yield text, lang, centers, k2
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        k1, k2 = 3 + seed % 3, 2 + seed % 4
        n = k1 * k2
        lang = dict(leaf_feat=rng.normal(size=(n, 512)).astype(np.float32),
                    occu_count=rng.integers(0, 12, n).astype(np.float32))
        base = rng.normal(size=(1, 6)).astype(np.float32)
        centers = (base + rng.normal(0, 0.3, (n + 1, 6))).astype(np.float32)
        text = (lang["leaf_feat"][rng.integers(n)]
                + rng.normal(0, 0.5, 512)).astype(np.float32)
        yield text, lang, centers, k2


def test_text_selection_matches_jax():
    expanded = 0
    for text, lang, centers, leaf_num in text_cases():
        want = jtext.select_leaves_by_text(text, lang, centers, leaf_num)
        got = ttext.select_leaves_by_text(text, lang, centers, leaf_num)
        np.testing.assert_array_equal(got, want)
        expanded += len(got) > 1
    assert expanded >= 2  # the top-k expansion ran, not only the argmax


def test_click_selection_matches_jax():
    # tests/test_eval_tools.py's case: the feature of root 1 / leaf 3
    rng = np.random.default_rng(2)
    k1, k2 = 3, 2
    roots = rng.normal(size=(k1, 9)).astype(np.float32)
    leaves = rng.normal(size=(k1 * k2 + 1, 6)).astype(np.float32)
    f = leaves[1 * k2 + 1]
    roots[1, :6] = f
    fn = (f / np.linalg.norm(f)).astype(np.float32)
    assert tclick.select_leaf_by_feature(fn, roots, leaves, k2) == 3
    seen = set()
    for seed in range(20):
        rng = np.random.default_rng(200 + seed)
        k1, k2 = 5, 4
        roots = rng.normal(size=(k1, 9)).astype(np.float32)
        leaves = rng.normal(size=(k1 * k2 + 1, 6)).astype(np.float32)
        feat = np.clip(rng.normal(0, 0.5, 6), -1, 1).astype(np.float32)
        want = jclick.select_leaf_by_feature(feat, roots, leaves, k2)
        assert tclick.select_leaf_by_feature(feat, roots, leaves, k2) == want
        seen.add(want)
    assert len(seen) > 3


def test_decode_feature_at_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(2))
    Image.fromarray(a).save(tmp_path / "a.png")
    Image.fromarray(b).save(tmp_path / "b.png")
    for x, y in ((0, 0), (17, 31), (W - 1, H - 1)):
        got = tclick.decode_feature_at(str(tmp_path / "a.png"), str(tmp_path / "b.png"), x, y)
        want = jclick.decode_feature_at(str(tmp_path / "a.png"), str(tmp_path / "b.png"), x, y)
        np.testing.assert_array_equal(got, want)


def test_decode_features_and_nearest_roots_match_jax_per_pixel(tmp_path):
    # the whole-map helpers give, pixel for pixel, the JAX click's feature
    # and the root its leaf lies in
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(2))
    Image.fromarray(a).save(tmp_path / "a.png")
    Image.fromarray(b).save(tmp_path / "b.png")
    k1, k2 = 5, 4
    roots = rng.normal(size=(k1, 9)).astype(np.float32)
    leaves = rng.normal(size=(k1 * k2 + 1, 6)).astype(np.float32)
    assert tclick.leaf_slots(leaves.shape[0], k1) == k2
    feats = tclick.decode_features(str(tmp_path / "a.png"), str(tmp_path / "b.png"))
    assert feats.shape == (H, W, 6)
    root = tclick.nearest_roots(feats.reshape(-1, 6), roots).reshape(H, W)
    seen = set()
    for x, y in zip(rng.integers(0, W, 40), rng.integers(0, H, 40)):
        want = jclick.decode_feature_at(str(tmp_path / "a.png"), str(tmp_path / "b.png"),
                                        int(x), int(y))
        np.testing.assert_array_equal(feats[y, x], want)
        assert root[y, x] == jclick.select_leaf_by_feature(want, roots, leaves, k2) // k2
        seen.add(int(root[y, x]))
    assert len(seen) > 1


def selection_state(n=320, cap=384, seed=7):
    """Two packages' copies of one state: opaque splats in front of the
    camera, about a third of them with an axis past LEAF_SCALE_LIMIT, and a
    random selection of half the slots (dead slots included)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0, 0.5, n), rng.normal(0, 0.4, n),
                    rng.permutation(np.linspace(2.5, 5.0, n))], -1).astype(np.float32)
    state = JG.create_from_pcd(pts, rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                               capacity=cap)
    log_scales = np.log(rng.uniform(0.03, 0.16, (cap, 3))).astype(np.float32)
    feat = rng.normal(size=(cap, 6)).astype(np.float32)
    state = state.with_params({**state.params(),
                               "logit_opacity": jnp.where(state.alive, 2.0, -10.0),
                               "log_scales": jnp.asarray(log_scales),
                               "ins_feat": jnp.asarray(feat)})
    t_state = TG.state_from_numpy({k: np.asarray(getattr(state, k))
                                   for k in JG.PARAM_FIELDS + ("alive",)}, device="cpu")
    select = rng.random(cap) < 0.5
    return state, t_state, select


@pytest.mark.parametrize("payload_rgb", [True, False])
@pytest.mark.parametrize("better_vis", [True, False])
def test_render_selection_matches_jax(payload_rgb, better_vis):
    state, t_state, select = selection_state()
    kw = dict(payload_rgb=payload_rgb, better_vis=better_vis)
    want = jax.jit(lambda st: j_render_selection(make_cam(W, H), st, jnp.ones(3),
                                                 jnp.asarray(select), PALLAS, **kw))(state)
    got = render_selection(tcam.Camera.from_fov(np.eye(3), np.zeros(3), 0.9, 0.7, W, H),
                           t_state, torch.ones(3), torch.as_tensor(select), TCFG, **kw)
    C = 3 if payload_rgb else 6
    assert got.cluster_imgs.shape == (H, W, C) and got.cluster_silhouettes.shape == (H, W)
    np.testing.assert_allclose(got.cluster_imgs.numpy(), np.asarray(want.cluster_imgs), **TOL)
    np.testing.assert_allclose(got.cluster_silhouettes.numpy(),
                               np.asarray(want.cluster_silhouettes), **TOL)
    for k in ("cluster_occur", "cluster_valid"):
        assert got.__dict__[k].shape == ()
        assert bool(got.__dict__[k]) == bool(np.asarray(getattr(want, k))), k
    assert int(want.n_lost) == int(got.n_lost) == 0
    assert bool(got.cluster_valid) and float(got.cluster_silhouettes.max()) > 0.5
    if better_vis:  # the cull drops splats the selection holds
        small = np.asarray(jnp.all(state.scales < 0.1, axis=-1))
        alive = np.asarray(state.alive)
        assert 0 < (select & alive & small).sum() < (select & alive).sum()


def write_model(tmp_path):
    """A 3-view COLMAP scene and a model directory as cli.train leaves it at
    iteration 40: six blobs of splats, each one leaf of a 3 x 2 codebook
    (leaf = root * 2 + j) with its own instance feature, the root and leaf
    codebooks, and a cluster_lang.npz whose table matches text "toy object"
    to leaf 3 and "second object" to leaf 0. -> (scene dir, model dir,
    text-feature .zip path)."""
    scene = str(tmp_path / "scene")
    make_colmap_scene(scene, n_views=3, with_sidecars=False)
    rng = np.random.default_rng(11)
    n_leaf, per = K1 * K2, 70
    centers_xyz = rng.normal(0, 0.45, (n_leaf, 3))
    leaf_feat6 = rng.normal(size=(n_leaf, 6)).astype(np.float32)
    leaf_of = np.repeat(np.arange(n_leaf), per)
    n = len(leaf_of)
    pts = (centers_xyz[leaf_of] + rng.normal(0, 0.12, (n, 3))).astype(np.float32)
    pts[:3] += 5.0  # a few outliers for the KNN mask
    state = JG.create_from_pcd(pts, rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
                               capacity=512)
    log_scales = np.log(rng.uniform(0.02, 0.12, (512, 3))).astype(np.float32)
    feat = np.zeros((512, 6), np.float32)
    feat[:n] = leaf_feat6[leaf_of] + rng.normal(0, 0.05, (n, 6))
    state = state.with_params({**state.params(),
                               "logit_opacity": jnp.where(state.alive, 3.0, -10.0),
                               "log_scales": jnp.asarray(log_scales),
                               "ins_feat": jnp.asarray(feat)})
    model = tmp_path / "model"
    pc = model / "point_cloud" / "iteration_40"
    pc.mkdir(parents=True)
    save_gaussian_ply(str(pc / "point_cloud.ply"), state)
    norm = leaf_feat6 / np.linalg.norm(leaf_feat6, axis=1, keepdims=True)
    roots = np.concatenate([norm.reshape(K1, K2, 6).mean(1),
                            centers_xyz.reshape(K1, K2, 3).mean(1)], -1)
    leaf_centers = np.concatenate([leaf_feat6, np.zeros((1, 6), np.float32)])
    save_codebook(str(pc / "root_code_book"), roots.astype(np.float32), leaf_of // K2)
    save_codebook(str(pc / "leaf_code_book"), leaf_centers, leaf_of)
    table = np.zeros((n_leaf, 512), np.float32)
    table[3, 3] = table[0, 0] = 1.0
    table[1, 0] = 0.5
    np.savez(model / "cluster_lang.npz", leaf_feat=table,
             leaf_score=np.full(n_leaf, 0.9, np.float32),
             occu_count=np.full(n_leaf, 10.0, np.float32), leaf_ind=leaf_of)
    tf = tmp_path / "text_features.zip"
    with zipfile.ZipFile(tf, "w") as z:
        z.writestr("text_features.json", json.dumps(
            {"toy object": table[3].tolist(), "second object": (table[0] + 0.1).tolist()}))
    return scene, str(model), str(tf)


def png_tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


def assert_pngs_close(dir_a, dir_b):
    names = png_tree(dir_a)
    assert names and png_tree(dir_b) == names
    for name in names:
        a = np.asarray(Image.open(os.path.join(dir_a, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(dir_b, name)), np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, name
    return names


def test_query_clis_match_jax(tmp_path, capsys):
    """Both CLIs on one model directory: the same leaves, the same file
    tree, PNGs within 1 LSB."""
    scene, model, tf = write_model(tmp_path)
    # the click reads the feature maps cli.render writes
    assert tcli_render.main(["-m", model, "-s", scene, "--skip_test"], device="cpu") == 2
    jmodel, tmodel = str(tmp_path / "model_jax"), str(tmp_path / "model_torch")
    shutil.copytree(model, jmodel)
    shutil.copytree(model, tmodel)
    capsys.readouterr()

    texts = ["toy object", "second object", "no such text"]
    args = ["-s", scene, "--scene_name", "toy", "--text_features", tf, "--texts", *texts]
    jtext.main(["-m", jmodel, *args])
    jout = capsys.readouterr().out
    recs = ttext.main(["-m", tmodel, *args], device="cpu")
    want = {m[0]: json.loads(m[1]) for m in re.findall(r"query '(.+)' -> leaves (\[.*\])", jout)}
    assert {r["text"]: r["leaves"] for r in recs} == want
    assert want["toy object"][0] == 3 and want["second object"][0] == 0
    for r in recs:
        assert r["frames"] == ["img_000", "img_001", "img_002"]
        assert r["members"] >= r["after_knn"] >= r["after_cull"] > 0
    assert recs[0]["members"] == 70 and recs[0]["after_knn"] < 70  # the KNN mask dropped some
    names = assert_pngs_close(os.path.join(jmodel, "text2obj"),
                              os.path.join(tmodel, "text2obj"))
    assert len(names) == 2 * 3 * 2  # (RGB, silhouette) x frames x answered texts
    rgb = [np.asarray(Image.open(os.path.join(tmodel, "text2obj", n)))
           for n in names if "silhouette" not in n]
    assert any(im.min() < 250 for im in rgb)  # the object tints the white background

    # the click: the brightest feature pixel of view 0, in both packages
    f1 = np.asarray(Image.open(os.path.join(model, "train/ours/ins_feat1/00000.png")))
    y, x = np.unravel_index(np.argmax(f1.sum(axis=-1)), f1.shape[:2])
    cargs = ["-s", scene, "--view", "00000", "--click", str(int(x)), str(int(y))]
    capsys.readouterr()
    jclick.main(["-m", jmodel, *cargs])
    leaf = int(re.search(r"-> leaf (\d+)", capsys.readouterr().out).group(1))
    rec = tclick.main(["-m", tmodel, *cargs], device="cpu")
    assert rec["leaf"] == leaf and rec["after_cull"] > 0
    assert rec["out_dir"] == os.path.join(tmodel, "click2obj", "ours_40")
    names = assert_pngs_close(os.path.join(jmodel, "click2obj"),
                              os.path.join(tmodel, "click2obj"))
    assert names == [f"ours_40/img_00{i}_leaf{leaf}.png" for i in range(3)]
