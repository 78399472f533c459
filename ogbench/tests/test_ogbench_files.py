"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract where a test can tell."""

import importlib
import inspect
import json
import os
import re

import pytest

from ogbench import run, stages

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ogbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    assert cfg["file"].startswith("ogbench/")
    d = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert d["name"] == cfg["name"]
    for k in cfg["reduced"]:
        assert k in d["opt"] or k in d["scene"]
    from opengaussian_tpu_torch.config import PRESETS

    preset = PRESETS[d["preset"]]
    changed = {k for k, v in d["opt"].items() if getattr(preset.opt, k) != v}
    assert changed == set(cfg["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = run.load_cell(name)
    stage = stages.load(cell["traffic"]["stage"])
    assert cell["stage"] == stage and stage.id == cell["traffic"]["stage"]
    assert all(callable(getattr(stage, f)) for f in stages.Stage._fields
               if f not in ("id", "payload_width"))
    assert isinstance(stage.payload_width, int) and stage.payload_width > 0
    assert set(cell["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "step_ms"}
    for m in cell["per_layer"]:
        mod = importlib.import_module(f"ogbench.metrics.{m['name']}")
        assert callable(mod.read)


def _data(folder):
    return sorted(os.listdir(os.path.join(ROOT, "ogbench", folder)))


@pytest.mark.parametrize("name", _data("limits"))
def test_limits_file_loads(name):
    d = json.load(open(os.path.join(ROOT, "ogbench", "limits", name)))
    for k in ("loss_gap", "grad_gap", "change_gap"):
        lo, hi = d["readings"]["lower"][k], d["readings"]["control"][k]
        assert lo < d[k] < hi  # between the program's readings and the control's


@pytest.mark.parametrize("mix", _data("traffic"))
def test_traffic_file_loads(mix):
    d = json.load(open(os.path.join(ROOT, "ogbench", "traffic", mix)))
    for k in ("stage", "start_iteration", "check_steps", "warmup_steps", "chunk_steps",
              "gap_steps", "adam_nu0"):
        assert k in d
    assert set(d["adam_nu0"]) == set(run.LEAVES)
    from opengaussian_tpu_torch.train.loop import Trainer

    # a call of the window ends where a user's run logs anyway
    log_every = inspect.signature(Trainer.train).parameters["log_every"].default
    assert d["chunk_steps"] % log_every == 0
