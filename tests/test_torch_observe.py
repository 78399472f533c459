"""The port's training observability (train/observe.py) and remote viewer
(viewer/network_gui.py) against the JAX package's.

The dumps: both trainers are given one state, one codebook and one set of
pseudo labels, carried across as numpy arrays, and dump the same view at
stages 0, 1, 2.1 and 2.2; the JAX side renders through its XLA blend, the
port through K1's plain version. The viewer: a SIBR client on the loopback
interface, every socket with a timeout and the test under an alarm of its
own, so that nothing can block the suite.
"""

import json
import os
import signal
import socket
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from opengaussian_tpu.config import Config as JConfig
from opengaussian_tpu.config import OptimizationConfig as JOpt
from opengaussian_tpu.data import dataset as jdataset
from opengaussian_tpu.models import gaussians as JG
from opengaussian_tpu.ops.kmeans import KMeansState as JKMeans
from opengaussian_tpu.ops.rasterize import RasterizeConfig as JRaster
from opengaussian_tpu.train import loop as jloop
from opengaussian_tpu.train import observe as jobserve
from opengaussian_tpu.train.pseudo import PseudoLabels as JPseudo
from opengaussian_tpu_torch.cli import train as tcli_train
from opengaussian_tpu_torch.config import Config as TConfig
from opengaussian_tpu_torch.config import OptimizationConfig as TOpt
from opengaussian_tpu_torch.data import dataset as tdataset
from opengaussian_tpu_torch.models import gaussians as TG
from opengaussian_tpu_torch.ops.kmeans import kmeans_from_numpy
from opengaussian_tpu_torch.ops.rasterize import RasterizeConfig as TRaster
from opengaussian_tpu_torch.train import loop as tloop
from opengaussian_tpu_torch.train import observe as tobserve
from opengaussian_tpu_torch.train.pseudo import pseudo_from_numpy
from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

OPT = dict(iterations=40, start_ins_feat_iter=10, start_root_cb_iter=20,
           start_leaf_cb_iter=30, root_node_num=4, leaf_node_num=3,
           densify_from_iter=1000, sam_level=3)
STAGES = {"0": 5, "1": 15, "2.1": 25, "2.2": 35}  # an iteration of each stage


@pytest.fixture
def alarm():
    """Fail the test, instead of hanging the suite, past 120 s."""
    def fire(*_):
        raise TimeoutError("the viewer test ran past its 120 s limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def png_tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def carried_trainers(tmp_path):
    """A JAX and a port Trainer on one 4-view scene, holding the same state
    (seeded features), codebook and pseudo labels."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=4)
    jtr = jloop.Trainer(jdataset.load_scene(root), JConfig(opt=JOpt(**OPT)),
                        str(tmp_path / "jax"),
                        rcfg=JRaster(max_per_tile=256, chunk=32, min_intersections=16384,
                                     backend="xla"), autotune_budgets=False)
    ttr = tloop.Trainer(tdataset.load_scene(root), TConfig(opt=TOpt(**OPT)),
                        str(tmp_path / "torch"), rcfg=TRaster(max_per_tile=256, chunk=32),
                        device="cpu")
    rng = np.random.default_rng(3)
    cap = jtr.state.capacity
    jtr.state = jtr.state.with_params({
        **jtr.state.params(),
        "ins_feat": jnp.asarray(rng.normal(size=(cap, 6)).astype(np.float32)),
        "logit_opacity": jnp.where(jtr.state.alive, 2.0, -10.0)})
    ttr.state = TG.state_from_numpy({k: np.asarray(getattr(jtr.state, k))
                                     for k in JG.PARAM_FIELDS + ("alive",)}, device="cpu")
    k1, k2 = OPT["root_node_num"], OPT["leaf_node_num"]
    kms = dict(centers=rng.normal(size=(k1, 9)), cls_ids=rng.integers(0, k1, cap),
               leaf_centers=rng.normal(size=(k1 * k2 + 1, 6)),
               leaf_cls_ids=rng.integers(0, k1 * k2, cap), leaf_sub_num=np.full(k1, k2))
    jtr.kms = JKMeans(**{k: jnp.asarray(v, jnp.int32 if "ids" in k or "num" in k
                                        else jnp.float32) for k, v in kms.items()})
    ttr.kms = kmeans_from_numpy(kms, device="cpu")
    V, Hh, Ww = ttr.bundle.gt_images.shape[:3]
    feat = rng.uniform(-1, 1, (V, Hh, Ww, 6)).astype(np.float32)
    ids = rng.integers(0, 3, (V, Hh, Ww)).astype(np.int32)
    jtr.pseudo = JPseudo(feat=jnp.asarray(feat), mask_ids=jnp.asarray(ids))
    ttr.pseudo = pseudo_from_numpy(feat, ids, device="cpu")
    return jtr, ttr


def test_dump_intermediate_writes_the_jax_artifact_set(tmp_path):
    jtr, ttr = carried_trainers(tmp_path)
    for stage, it in STAGES.items():
        jobserve.dump_intermediate(jtr, it, stage, 1)
        tobserve.dump_intermediate(ttr, it, stage, 1)
    jdir, tdir = str(tmp_path / "jax" / "train_process"), str(tmp_path / "torch" / "train_process")
    names = png_tree(jdir)
    assert png_tree(tdir) == names
    for sub in ("stage1", "stage2_1", "stage2_2"):  # each feature stage's set
        assert any(n.startswith(sub + "/ins_feat2/") for n in names)
        assert any(n.startswith(sub + "/gt_sam_mask_3/") for n in names)
        assert any(n.startswith(sub + "/pseudo_ins_feat/") for n in names)
    assert any(n.startswith("stage2_2/silhouette/") for n in names)
    assert not any(n.startswith("stage1/silhouette/") for n in names)
    assert len(names) == 2 * 4 + 5 * 3 + 2  # gt + renders per stage, 5-6 per feature stage
    for n in names:
        a = np.asarray(Image.open(os.path.join(jdir, n)), np.int16)
        b = np.asarray(Image.open(os.path.join(tdir, n)), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, n
    img = np.asarray(Image.open(os.path.join(tdir, "renders/00005.png")))
    assert img.max() > 0


@pytest.mark.parametrize("n", [0, 5, 10, 511, 600])
def test_mask_palette_equals_jax(n, monkeypatch):
    monkeypatch.setattr(jobserve, "_PALETTE", None)  # the JAX package caches one
    np.testing.assert_array_equal(tobserve.mask_palette(n), jobserve.mask_palette(n))
    assert (tobserve.mask_palette(n)[0] == 0).all()
    np.testing.assert_array_equal(tobserve.mask_palette(n)[:6],  # one palette, any n
                                  tobserve.mask_palette(5)[: min(n + 1, 6)])


@pytest.mark.parametrize("disable", [False, True])
def test_cli_train_dumps_unless_disabled(tmp_path, monkeypatch, disable):
    """With the dump frequency set to every iteration, cli.train writes one
    dump per step, and --disable_intermediate_dumps writes none."""
    monkeypatch.setattr(tobserve, "dump_frequency", lambda stage: 1)
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=2, with_sidecars=False)
    out = str(tmp_path / "model")
    flags = ["--disable_intermediate_dumps"] if disable else []
    tr = tcli_train.main(["-s", root, "-m", out, "--iterations", "2", "-r", "2", *flags],
                         device="cpu")
    assert tr.iteration == 2 and tr.save_intermediate == (not disable)
    tp = os.path.join(out, "train_process")
    if disable:
        assert not os.path.exists(tp)
    else:
        assert png_tree(tp) == ["gt/00001.png", "gt/00002.png", "renders/00001.png",
                                "renders/00002.png"]


def sibr_payload(w2c, width, height, fovx, fovy, train=True, keep_alive=False):
    """A camera as the SIBR client encodes it: the transposed w2c with
    columns 1 and 2 negated (tests/test_viewer.py)."""
    m = np.asarray(w2c, np.float32).T.copy()
    m[:, 1] = -m[:, 1]
    m[:, 2] = -m[:, 2]
    msg = dict(resolution_x=width, resolution_y=height, train=train, fov_y=fovy, fov_x=fovx,
               z_near=0.01, z_far=100.0, shs_python=False, rot_scale_python=False,
               keep_alive=keep_alive, scaling_modifier=1.0,
               view_matrix=[float(x) for x in m.reshape(-1)],
               view_projection_matrix=[0.0] * 16)
    data = json.dumps(msg).encode("utf-8")
    return struct.pack("<I", len(data)) + data


def recv_exact(sock, n):
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        assert chunk, "server closed early"
        out += chunk
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_viewer_loopback_render_and_resume(tmp_path, alarm):
    """A SIBR request, queued before the poll, is served at the next
    iteration with exactly the bytes of a render of the state at that
    iteration through the request's camera; the client's end of stream
    drops it and training resumes."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_views=2, with_sidecars=False)
    tr = tloop.Trainer(tdataset.load_scene(root, resolution=2),
                       TConfig(opt=TOpt(iterations=4, densify_from_iter=100)),
                       str(tmp_path / "out"), rcfg=TRaster(max_per_tile=256, chunk=32),
                       device="cpu")
    port = free_port()
    tr.viewer_port = port
    try:
        tr.train(until=1, log_every=1)  # the first poll opens the listener
        assert tr.viewer is not None and tr.viewer.conn is None
        served_state = tr.state  # what iteration 2's poll renders
        W, H = 32, 24
        w2c = np.eye(4, dtype=np.float32)
        w2c[2, 3] = 4.0  # the scene's points sit around the origin
        with socket.create_connection(("127.0.0.1", port), timeout=30) as c:
            c.sendall(sibr_payload(w2c, W, H, fovx=1.0, fovy=0.8))
            c.shutdown(socket.SHUT_WR)  # then the end of stream: the viewer leaves
            tr.train(until=3, log_every=1)
            img = recv_exact(c, H * W * 3)
            (plen,) = struct.unpack("<I", recv_exact(c, 4))
            path = recv_exact(c, plen).decode()
        assert tr.iteration == 3 and tr.viewer.conn is None  # resumed, viewer dropped
        assert path == str(tmp_path / "out")  # no source_path in the config: the output
        cur, tr.state = tr.state, served_state
        direct = tr._viewer_render(dict(width=W, height=H, fovx=1.0, fovy=0.8, w2c=w2c), 1.0)
        tr.state = cur
        assert img == direct
        arr = np.frombuffer(img, np.uint8).reshape(H, W, 3)
        assert (arr > 0).any(-1).mean() > 0.1  # the splats are in view
    finally:
        if tr.viewer is not None:
            tr.viewer.close()
