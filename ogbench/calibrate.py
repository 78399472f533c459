"""The readings the limits of a cell are set from, at the cell's own size, in
one process on the card:

    python3 -m ogbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

For each of --seeds, the program's readings: the set-up and first steps of
a run (ogbench/run.py:setup), the reference's (the stage module's
`follow`), and their gaps (ogbench/compare.py). For each of
--control-seeds, the control's and a fault's readings, each against the
float32 reference: the control is the reference put in the program's place
and computed in TF32 (the nearest precision below the configuration's
float32 with TF32 off); the fault leaves half the frame out of the loss
("half"). A state left unchanged reads 1 on change_gap by construction and
needs no run.

Prints one JSON line per reading, then a summary: the largest program
reading of each number (the lower reading), the smallest control reading
and the smallest fault reading (the upper readings), and the mean squared
first gradient of each leaf of the reference (the scale of the mix's
start moments, `adam_nu0`).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import torch

from ogbench import compare, run


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    cell = run.load_cell(a.workload)
    cfg, traffic, stage = cell["config"], cell["traffic"], cell["stage"]
    dev = torch.device("cuda")
    lows, ctls, faults, g2 = [], [], [], {}

    def emit(rec):
        print(json.dumps(rec), flush=True)

    for seed in _seeds(a.seeds):
        out_dir = tempfile.mkdtemp(prefix="ogbench-cal-")
        try:
            t0 = time.perf_counter()
            tr, inputs, prog, parts = run.setup(cell, seed, dev, out_dir)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            plans = tr._frozen_plans
            plans = "off" if plans is False else "none" if plans is None else "built"
            del tr
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = stage.follow(cfg, traffic, inputs, seed, dev)
            ref_s = time.perf_counter() - t1
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        start = {k: inputs["splats"][k] for k in run.LEAVES}
        g = compare.gaps(prog, ref, start)
        for k, v in ref["first_grads"].items():
            g2.setdefault(k, []).append(float((v.double() ** 2).mean()))
        lows.append(g)
        emit(dict(kind="program", seed=seed, setup_s=setup_s, setup_parts=parts,
                  reference_s=ref_s, plans=plans,
                  prog_losses=prog["losses"], ref_losses=ref["losses"], **g))
    for seed in _seeds(a.control_seeds):
        inputs = run.make_inputs(cfg, traffic, seed, dev)
        ref = stage.follow(cfg, traffic, inputs, seed, dev)
        start = {k: inputs["splats"][k] for k in run.LEAVES}
        for kind, prec, fault, into in (("control", "tf32", None, ctls),
                                        ("fault_half", "fp32", "half", faults)):
            other = stage.follow(cfg, traffic, inputs, seed, dev, prec, fault)
            g = compare.gaps(other, ref, start)
            into.append(g)
            emit(dict(kind=kind, seed=seed, **g))
    summary = dict(workload=a.workload)
    for name in compare.NAMES:
        if lows:
            summary[f"{name}_lower"] = max(g[name] for g in lows)
        if ctls:
            summary[f"{name}_control"] = min(g[name] for g in ctls)
        if faults:
            summary[f"{name}_fault_half"] = min(g[name] for g in faults)
    summary["ref_grad_sq_mean"] = {k: sum(v) / len(v) for k, v in g2.items()}
    emit(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
