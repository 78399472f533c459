"""The reference against the port at a small size on the CPU, through a
whole run of each cell (ogbench/run.py:run, the look for a card skipped);
the control (the reference in TF32) and the faults, each of which a run
must report as not correct."""

import json
import os

import pytest
import torch

from ogbench import compare, run
from ogbench.tests.conftest import SMALL, SMALL_MIX

SEED = 2_718_281_828  # past 2**31, as the driver's are
CELLS = [w["name"] for w in json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))["workloads"]]


def _run(cell, trace=False):
    """A whole run of the cell on the CPU (its window one call long)."""
    return run.run(cell, SEED, 0.0, trace, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_the_reference(cell, small):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert 1 <= res["attempted"] <= SMALL_MIX["chunk_steps"] and res["failed"] == 0
    assert set(res["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_counts(cell, small):
    """The traced window on the CPU: an untraced call timed, the next one
    profiled, then the host window; the readers that need the card's trace,
    spans or peaks find nothing and are left out, the counts and the
    trainer's counters are read."""
    res = _run(cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["device"]["window_s"] > 0
    assert set(res["metrics"]) == {"slot_fill", "live_slot_fill"}
    fill, live = (res["metrics"][k]["value"] for k in ("slot_fill", "live_slot_fill"))
    # the counters keep the rect slots the circle cull rejects; the recount does not
    assert 0 < fill <= live <= 100


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in TF32, put in the program's place, fails a limit."""
    c = run.load_cell(cell)
    c["config"]["scene"].update(SMALL)
    dev = torch.device("cpu")
    inputs = run.make_inputs(c["config"], c["traffic"], SEED, dev)
    ref = c["stage"].follow(c["config"], c["traffic"], inputs, SEED, dev)
    ctl = c["stage"].follow(c["config"], c["traffic"], inputs, SEED, dev, precision="tf32")
    g = compare.gaps(ctl, ref, {k: inputs["splats"][k] for k in run.LEAVES})
    ok, checks = compare.verdict(g, c["limits"])
    assert not ok, checks


def _unchanged(monkeypatch):
    """Adam returns the parameters and moments it was given."""
    from opengaussian_tpu_torch.models import optimizer as opt_mod

    def apply(params, grads, state, lrs, bias=None):
        return dict(params), opt_mod.AdamState(mu=state.mu, nu=state.nu,
                                               count=state.count + 1)

    monkeypatch.setattr(opt_mod, "apply", apply)


def _half_batch(monkeypatch):
    """The loss over the upper half of the frame's pixels alone (stage 0's
    photometric loss; stage 1's masks)."""
    from opengaussian_tpu_torch.train import losses
    from opengaussian_tpu_torch.utils import masks

    rgb, onehot = losses.rgb_loss, masks.masks_onehot

    def half_rgb(pred, gt, lam=0.2):
        h = pred.shape[0] // 2
        return rgb(pred[:h], gt[:h], lam)

    def half_masks(ids, m):
        ids = ids.clone()
        ids[ids.shape[0] // 2:] = 0
        return onehot(ids, m)

    monkeypatch.setattr(losses, "rgb_loss", half_rgb)
    monkeypatch.setattr(masks, "masks_onehot", half_masks)


def _altered(monkeypatch):
    """The rendered image altered where the render produces it."""
    import dataclasses

    from opengaussian_tpu_torch.train import loop

    render = loop.render

    def altered(*a, **k):
        out = render(*a, **k)
        upd = {f: getattr(out, f) * 1.01 for f in ("render", "ins_feat")
               if getattr(out, f) is not None}
        return dataclasses.replace(out, **upd)

    monkeypatch.setattr(loop, "render", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_a_fault_underneath_is_not_correct(cell, fault, monkeypatch, small):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
def test_a_run_on_the_card(card):
    """One short run of the first cell on the card at its full size."""
    res = run.run("lerf-teatime.s0-train", SEED, 2.0, False, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
