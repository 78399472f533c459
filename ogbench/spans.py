"""Print one cell's span table: the program's device time a step under each
of its spans (opengaussian_tpu_torch/utils/trace.py), the device's idle gaps
named by the spans around them, and the trainer's slot counters beside the
recount that the benchmark's slot_fill reads.

    python3 -m ogbench.spans --workload <cell> --seed <n> [--steps 16]

Set-up as ogbench/run.py (`run.setup`). Then one call of the window to the
next multiple of `chunk_steps`, untraced: its wall time per step, and the
trainer's counters across it (`Trainer.counters`, summed at the log
boundary it ends on). Then the steps that a traced run's device window
takes (`gap_steps`, and on to the next multiple of `chunk_steps`),
untraced, so that what follows covers the traced run's own steps and
views. Then --steps steps traced with the host's operations and the
device's: device milliseconds a step by span
(ogbench/trace.py:device_ms_by_span, the program's reduction copied: the
innermost span, a backward node's kernels with its forward's span), the
same table a traced run of the benchmark reads ("spans",
ogbench/run.py:traced_window), the device's busy time (the union of its
operations' intervals) and idle gaps (ogbench/trace.py), the counters'
live fill of the padded stream over those steps, and `slot_fill`'s recount
of the same steps (ogbench/counts.py:frame_work on the start's splats);
last, the spans opened a step and what one costs the host with no
profiler recording and with one. The table goes to standard error, one
JSON object to standard output.

A measuring tool beside the benchmark: no cell runs it, and it needs a
program that has the spans and counters.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from ogbench import run as R
from ogbench.trace import UNPLACED, device_ms_by_span, device_record, idle_gaps


def span_cost_us(n: int = 20000) -> tuple[float, float]:
    """Microseconds to enter and leave one span with no profiler recording
    (the shared no-op context) and with one recording the host."""
    from torch.profiler import ProfilerActivity, profile

    from opengaussian_tpu_torch.utils.trace import STEP, span

    def loop() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with span(STEP):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    with profile(activities=[ProfilerActivity.CPU]):
        on = loop()
    return off, on


def fill(delta: dict) -> float | None:
    return 100.0 * delta["live"] / delta["padded"] if delta["padded"] else None


def main(argv=None, device="cuda") -> int:
    """device: "cpu" rehearses the tool on the CPU (the tests), where the
    table holds the host operations' times."""
    from opengaussian_tpu_torch.utils.trace import SPANS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=16)
    a = p.parse_args(argv)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        R.log("ogbench.spans needs a CUDA card")
        return 2
    cell = R.load_cell(a.workload)
    traffic = cell["traffic"]
    out_dir = tempfile.mkdtemp(prefix="ogbench-")
    try:
        tr, inputs, _prog, _parts = R.setup(cell, a.seed, dev, out_dir)
        before = dict(tr.counters)
        plain = R.timed_window(tr, traffic, 0.0, dev)
        call = {k: tr.counters[k] - before[k] for k in before}
        tr.train(until=tr.iteration + int(traffic["gap_steps"]))
        R._train_to_boundary(tr, int(traffic["chunk_steps"]))
        it_start = tr.iteration
        delta, prof, wall = R.host_traced_steps(tr, a.steps, dev)
        rec = dict(first_step=it_start - int(traffic["start_iteration"]), steps=a.steps)
        rec.update(device_record(prof, wall))
        gaps = idle_gaps(prof)
        table = device_ms_by_span(prof, a.steps, SPANS, host_stand_in=dev.type == "cpu")
        opened = sum(e.name in SPANS for e in prof.events()) / a.steps
        slot_budget = (max(tr.rcfg.intersection_budget, tr.rcfg.min_intersections)
                       if tr.rcfg.intersection_budget else 0)
        del tr, prof
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        R.count_steps(rec, cell, inputs, a.seed, dev, None, None)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if not table:
        R.log("the trace holds no device operation: no span table")
        return 1
    busy_ms = rec["busy_s"] / a.steps * 1e3
    step_ms = plain["window_s"] / plain["steps"] * 1e3
    placed = sum(v for k, v in table.items() if k != UNPLACED)
    slot_fill = (100.0 * sum(w["live"] for w in rec["works"]) / (a.steps * slot_budget)
                 if slot_budget else None)
    card = R.power_limit() if dev.type == "cuda" else "cpu"
    off_us, on_us = span_cost_us()
    R.log(f"device: {card}; untraced {plain['steps']} steps at {step_ms:.3f} ms "
          f"a step; traced {a.steps} steps: busy {busy_ms:.3f} ms a step of "
          f"{wall / a.steps * 1e3:.3f}")
    total = sum(table.values())
    R.log("device ms a step by span (share of the device operations' sum):")
    for k, v in table.items():
        R.log(f"  {k:14s} {v:8.3f}  {100.0 * v / total:5.1f}%")
    R.log(f"  {'(sum)':14s} {total:8.3f}, placed {100.0 * placed / total:5.1f}%")
    R.log("idle gaps (ms, named by the host operation or span around them):")
    for name, s in gaps:
        R.log(f"  {s * 1e3:8.3f}  {name}")
    R.log(f"spans a step {opened:.1f}; a span costs {off_us:.3f} us with no profiler "
          f"recording, {on_us:.3f} us with one: {opened * off_us:.1f} / "
          f"{opened * on_us:.1f} us of host time a step")
    R.log(f"counters over the untraced call: {call}, live fill "
          f"{fill(call)}%; over the traced steps: {delta}, live fill {fill(delta)}%; "
          f"slot_fill's recount of the traced steps {slot_fill}%")
    print(json.dumps(dict(workload=a.workload, seed=a.seed, step_ms=step_ms, busy_ms=busy_ms,
                          spans_ms=table, idle_gaps=gaps, counters_call=call,
                          counters_traced=delta, live_fill_call=fill(call),
                          live_fill_traced=fill(delta), slot_fill=slot_fill,
                          spans_per_step=opened, span_off_us=off_us, span_on_us=on_us,
                          device=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
