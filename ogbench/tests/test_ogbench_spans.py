"""ogbench/spans.py at a small size on the CPU: the span table of each
cell's traced steps (the host operations standing for the device's), the
counters over them, and the recount beside them."""

import json

import pytest

from ogbench import spans
from ogbench.tests.test_ogbench_reference import CELLS, SEED

LAYERS = {"geometry", "blend", "blend.bwd", "reduce", "loss", "update"}


@pytest.mark.parametrize("cell", CELLS)
def test_span_table_of_a_cell(cell, small, capsys):
    assert spans.main(["--workload", cell, "--seed", str(SEED), "--steps", "2"],
                      device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    table = out["spans_ms"]
    assert LAYERS <= set(table) and "unplaced" not in table
    assert all(v >= 0 for v in table.values())
    assert out["counters_traced"]["steps"] == 2
    assert out["counters_traced"]["dropped"] == out["counters_traced"]["truncated"] == 0
    assert 0 < out["live_fill_traced"] <= 100 and 0 < out["slot_fill"] <= 100
    # the counters keep the rect slots the circle cull rejects; the recount does not
    assert out["live_fill_traced"] >= out["slot_fill"]
    assert out["spans_per_step"] > len(LAYERS) and out["span_off_us"] > 0


def test_the_span_reduction_copy_reads_as_the_programs(small, tmp_path):
    """ogbench/trace.py's copy of the program's reduction gives the program's
    table on a trace of the trainer's steps (the CPU's host operations
    standing for the device's)."""
    import torch

    from ogbench import run, trace
    from opengaussian_tpu_torch.utils import trace as program

    dev = torch.device("cpu")
    tr, _inputs, _prog, _parts = run.setup(run.load_cell(CELLS[0]), SEED, dev, str(tmp_path))
    _, prof, _ = run.host_traced_steps(tr, 2, dev)
    assert trace.span_ops(prof, program.SPANS, host_stand_in=True) == [
        (op.span, op.name, op.us) for op in program.device_ops(prof)]
    assert (trace.device_ms_by_span(prof, 2, program.SPANS, host_stand_in=True)
            == program.device_ms_by_span(prof, 2))
    # with no stand-in, a trace with no device track reads nothing
    assert trace.span_ops(prof, program.SPANS) == []
    assert trace.device_ms_by_span(prof, 2, program.SPANS) == {}
