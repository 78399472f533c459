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
