"""The stage modules (ogbench/stages/): the reference's steps and the counts
of stages 0 and 1 as the harness had them before they moved there, bit for
bit; a stage added by files alone; a reference that takes only the
benchmark's inputs; the readers of the traced run's spans and counters."""

import filecmp
import hashlib
import inspect
import json
import os
import shutil
import sys

import pytest
import torch

from ogbench import metrics, run, stages
from ogbench.tests.test_ogbench_reference import SEED

CPU = torch.device("cpu")
H100 = (67e12, 3.35e12)  # counts.peaks("NVIDIA H100 80GB HBM3")
VARIANTS = (("fp32", None), ("tf32", None), ("fp32", "half"))
WORK_KEYS = ("live", "tiles", "evaluated", "in_box", "tested", "blended", "boxes", "box_tests")

# The readings of the harness before the stage modules (ogbench/run.py:
# follow, count_steps and ogbench/counts.py:step_ops of the same tree with
# the stage branches in place), on the CPU in one thread at the tests' size
# (conftest.SMALL), seed SEED: for each of the reference's variants (precision,
# fault) its two losses (float.hex) and the first 8 hex digits of the
# SHA-256 of each leaf's first gradient and of its parameters after the two
# steps, in reference.LEAVES order; each traced step's frame_work (steps 4-7
# from the start, WORK_KEYS); count_steps' step_ops and its bounds on the
# H100's peaks (float.hex), and step_ops of the first traced step alone.
GOLDEN = {
    "lerf-teatime.s0-train": {
        "fp32.None": (("0x1.0b65080000000p-1", "0x1.0cc06a0000000p-1"),
                      "47a077c2 10a7d537 94622f8a 3e179c86 39646575 42c44bc0 3a3ed164",
                      "a2245938 1b99d7cc c9f2a589 b5d83c94 d78015e8 97a121cd fcb170a7"),
        "tf32.None": (("0x1.0b6b0e0000000p-1", "0x1.0cc6940000000p-1"),
                      "cf773b1b eb35c615 97e1db93 8a0c5cc7 d7300a69 56f85064 3a3ed164",
                      "34c32bd7 e430afcb d1c50296 5d0d9508 f1a6ecec b02a51eb fcb170a7"),
        "fp32.half": (("0x1.0a83a40000000p-1", "0x1.0a608c0000000p-1"),
                      "08251c5f 32eb852e d7ac71e4 40a2581e 617b7790 175a6c5b 3a3ed164",
                      "bc96431a bbefd86c d2f7cea1 37b24947 19a268be f2d11093 fcb170a7"),
        "works": [(4776, 80, 1222656, 347424, 64485, 64485, 4776, 38208),
                  (4776, 80, 1222656, 347424, 64485, 64485, 4776, 38208),
                  (4819, 80, 1233664, 352384, 65792, 65792, 4819, 38552),
                  (4779, 80, 1223424, 341152, 63782, 63782, 4779, 38232)],
        "counts": (284745400, "0x1.81f1c96284c5ap-21", "0x1.81a304036c630p-20", 71189815),
    },
    "lerf-teatime.s1-train": {
        "fp32.None": (("0x1.4becc80000000p-1", "0x1.44b8680000000p-1"),
                      "2aae7dc8 2aae7dc8 c2cd1bef 2aae7dc8 de2f2560 4fe7b59a 9ae22d5b",
                      "0771c4b0 2b2f4f96 b891bd6f e9ae0ae3 ae3df241 11d956e4 3ff8575c"),
        "tf32.None": (("0x1.4bde560000000p-1", "0x1.44c6ec0000000p-1"),
                      "2aae7dc8 2aae7dc8 c2cd1bef 2aae7dc8 de2f2560 4fe7b59a e3bfd898",
                      "0771c4b0 2b2f4f96 b891bd6f e9ae0ae3 ae3df241 11d956e4 82ea7350"),
        "fp32.half": (("0x1.34b2f20000000p-1", "0x1.553f640000000p-1"),
                      "2aae7dc8 2aae7dc8 c2cd1bef 2aae7dc8 de2f2560 4fe7b59a 009b1e18",
                      "0771c4b0 2b2f4f96 b891bd6f e9ae0ae3 ae3df241 11d956e4 c03a9e7d"),
        "works": [(4776, 80, 1222656, 347424, 64485, 64485, 4776, 38208),
                  (4776, 80, 1222656, 347424, 64485, 64485, 4776, 38208),
                  (4819, 80, 1233664, 352384, 65792, 65792, 4819, 38552),
                  (4779, 80, 1223424, 341152, 63782, 63782, 4779, 38232)],
        "counts": (119644162, "0x1.2228373c80498p-20", "0x1.2200d48cf4183p-19", 29911753),
    },
}


@pytest.fixture
def one_thread():
    """The reference's sums are exact to the bit in one thread; under more,
    the order of some reductions follows the threads' split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()[:8]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_stage_modules_keep_the_harness_readings_bit_for_bit(name, one_thread, small):
    cell = run.load_cell(name)
    cell["traffic"]["check_steps"] = 2
    stage, cfg, traffic = cell["stage"], cell["config"], cell["traffic"]
    inputs = run.make_inputs(cfg, traffic, SEED, CPU)
    want = GOLDEN[name]
    for prec, fault in VARIANTS:
        ref = stage.follow(cfg, traffic, inputs, SEED, CPU, prec, fault)
        got = (tuple(float(x).hex() for x in ref["losses"]),
               " ".join(_digest(ref["first_grads"][k]) for k in run.LEAVES),
               " ".join(_digest(ref["params"][k]) for k in run.LEAVES))
        assert got == want[f"{prec}.{fault}"], (prec, fault)
    rec = dict(first_step=3, steps=4)
    run.count_steps(rec, cell, inputs, SEED, CPU, *H100)
    assert [tuple(w[k] for k in WORK_KEYS) for w in rec["works"]] == want["works"]
    sc = cfg["scene"]
    first = stage.step_ops(rec["works"][0], sc["splats"], inputs["splats"]["means"].shape[0],
                           sc["width"], sc["height"])
    assert (rec["step_ops"], rec["fwd_bound_s"].hex(), rec["bwd_bound_s"].hex(),
            first) == want["counts"]


# -- a stage by files alone --

NEW_STAGE = '''"""A stage for the harness's test: stage 1's steps, with a start that
carries k-means codebooks."""

import numpy as np

from ogbench.stages.s1 import draws, follow, payload_width, step_ops, view_work  # noqa: F401


def start(cfg, traffic, inputs, seed):
    n = inputs["splats"]["means"].shape[0]
    k1, k2 = cfg["opt"]["root_node_num"], cfg["opt"]["leaf_node_num"]
    rng = np.random.default_rng(seed)
    return {"kmeans/centers": rng.random((k1, 9), dtype=np.float32),
            "kmeans/cls_ids": rng.integers(0, k1, n).astype(np.int32),
            "kmeans/leaf_centers": rng.random((k1 * k2 + 1, 6), dtype=np.float32),
            "kmeans/leaf_cls_ids": rng.integers(0, k1 * k2, n).astype(np.int32),
            "kmeans/leaf_sub_num": rng.integers(1, k2 + 1, k1).astype(np.int32)}
'''


def _add_stage_by_files(root):
    """Into a copy of BENCHMARK.json and ogbench/ at `root`: the stage
    module, a configuration, a mix, a limits file and the cell's entries.
    -> the cell's name."""
    ob = os.path.join(root, "ogbench")
    with open(os.path.join(ob, "stages", "s1_5.py"), "w") as f:
        f.write(NEW_STAGE)

    def copy_json(src, dst, **upd):
        with open(os.path.join(ob, src)) as f:
            d = json.load(f)
        d.update(upd)
        with open(os.path.join(ob, dst), "w") as f:
            json.dump(d, f)

    copy_json("configs/lerf-teatime.json", "configs/teatime-codebooks.json",
              name="teatime-codebooks")
    copy_json("traffic/s1-train.json", "traffic/s15-train.json", stage="1.5")
    copy_json("limits/lerf-teatime.s1-train.json", "limits/teatime-codebooks.s15-train.json")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="teatime-codebooks",
                                 file="ogbench/configs/teatime-codebooks.json"))
    bench["workloads"].append(dict(name="teatime-codebooks.s15-train",
                                   config="teatime-codebooks", traffic="s15-train", chips=1,
                                   why="stage 1 from a start with codebooks"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return "teatime-codebooks.s15-train"


def _same_files(root):
    """Every file of the repo's ogbench/ is in the copy, unchanged."""
    for d, _, files in os.walk(os.path.join(run.ROOT, "ogbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            mine = os.path.join(d, f)
            theirs = os.path.join(root, os.path.relpath(mine, run.ROOT))
            assert filecmp.cmp(mine, theirs, shallow=False), theirs


@pytest.fixture
def stages_of(monkeypatch):
    """Puts a copy's ogbench/stages/ first on the stage package's search
    path, as if its new modules were the repo's; forgets them after."""
    before = set(sys.modules)

    def put(root):
        monkeypatch.setattr(stages, "__path__",
                            [os.path.join(root, "ogbench", "stages"), *stages.__path__])

    yield put
    for m in set(sys.modules) - before:
        if m.startswith("ogbench.stages."):
            del sys.modules[m]


def test_a_stage_is_added_by_files_alone(tmp_path, small, stages_of):
    """The copy adds files and edits none of the harness's (`_same_files`),
    so the repo's harness, run over the copy's BENCHMARK.json and data with
    the copy's stage module found beside the repo's, runs as the copy's
    would."""
    root = str(tmp_path)
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(run.ROOT, "ogbench"), os.path.join(root, "ogbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = _add_stage_by_files(root)
    _same_files(root)
    stages_of(root)

    cell = run.load_cell(name, root)
    stage = cell["stage"]
    assert stage.id == "1.5" and stage.start.__module__ == "ogbench.stages.s1_5"
    cfg, traffic = cell["config"], cell["traffic"]
    inputs = run.make_inputs(cfg, traffic, SEED, CPU)
    tr = run.make_trainer(cell, inputs, SEED, CPU, str(tmp_path / "out"))
    for k, v in stage.start(cfg, traffic, inputs, SEED).items():
        assert torch.equal(getattr(tr.kms, k.split("/")[1]), torch.from_numpy(v)), k
    run.first_steps(tr, cell)

    ref = stage.follow(cfg, traffic, inputs, SEED, CPU)
    assert len(ref["losses"]) == traffic["check_steps"]
    rec = dict(first_step=0, steps=2)
    run.count_steps(rec, cell, inputs, SEED, CPU, *H100)
    assert len(rec["works"]) == 2 and rec["step_ops"] > 0 and rec["fwd_bound_s"] > 0

    # and a whole run of the cell from that checkout
    res = run.run(name, SEED, 0.0, False, device="cpu", root=root)
    assert res["correct"], res["checks"]


def test_a_stage_start_cannot_overwrite_the_harness_arrays(tmp_path, small):
    cell = run.load_cell("lerf-teatime.s0-train")
    inputs = run.make_inputs(cell["config"], cell["traffic"], SEED, CPU)
    with pytest.raises(ValueError, match="overwrite"):
        run.write_start(str(tmp_path / "x.npz"), inputs, 1,
                        {"state/means": inputs["splats"]["means"].numpy()})


@pytest.mark.parametrize("stage_id", ["0", "1"])
def test_a_reference_takes_only_the_benchmarks_inputs(stage_id):
    """`follow` has no way in for the program's state: it takes the
    configuration, the mix, the inputs made from the seed, the seed, and
    how to compute."""
    stage = stages.load(stage_id)
    assert list(inspect.signature(stage.follow).parameters) == [
        "cfg", "traffic", "inputs", "seed", "device", "precision", "fault"]
    assert set(stages.Stage._fields) == {"id", "draws", "follow", "payload_width",
                                         "view_work", "step_ops", "start"}


def test_an_unknown_stage_has_no_module():
    with pytest.raises(FileNotFoundError):
        stages.load("7")
    with pytest.raises(ValueError):
        stages.load("../s0")


# -- the readers of the spans and counters --

def _reader(name):
    import importlib

    return importlib.import_module(f"ogbench.metrics.{name}").read


def test_span_and_counter_readers():
    spans = {"update": 3.05, "bin": 2.6, "loss": 2.2, "blend": 0.96, "blend.bwd": 1.32,
             "reduce": 0.53, "geometry": 1.0, "train.view": 0.33}
    ctx = dict(spans=spans, counters=dict(steps=196, padded=4000, live=3100, dropped=0,
                                          truncated=0))
    want = dict(geometry_ms=1.0, bin_ms=2.6, loss_ms=2.2, update_ms=3.05,
                blend_ms=0.96 + 1.32 + 0.53, live_slot_fill=77.5)
    for name, v in want.items():
        assert _reader(name)(ctx) == pytest.approx(v, rel=1e-12), name
        # a trace with no device track (the CPU) or no counts: nothing to read
        assert _reader(name)(dict(spans=None, counters=dict(padded=0, live=0))) is None
    assert _reader("bin_ms")(dict(spans={"loss": 1.0})) is None
    assert metrics.span_ms(dict(spans={"reduce": 0.5}), ("blend", "reduce")) == 0.5
