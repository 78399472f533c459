"""A/B of the stream backward's variants on the card (the port's counterpart
of the JAX repo's tools/ab_reduce.py).

    python -m opengaussian_tpu_torch.tools.ab_reduce [--iters 20] [--reps 3]
        [--out FILE]

Crosses reduce_backend "scatter" (K3's atomic entry) and "sorted_mxu" (K3's
permutation entry, in the binning's fixed order) with bwd_layout "dense"
(K2: the replay's rows at their stream positions) and "compact" (K4: the
rows compacted by chunk with their splat ids), on tools/bench.py's
calibrated (scale 0.088) and r1-heavy (0.15) workloads, through bench's own
code:

  * the four variants' kernels against their plain versions
    (`bench.check_kernels`), before any timing;
  * every variant built and warmed, and its gradients held against
    scatter/dense's at 1e-4 normalised (the atomic K3 sums in an order that
    changes from run to run; 1e-4 covers it);
  * then `bench.ab_times`: --reps + 1 repetitions, the variants in a
    shuffled order in each, each sample --iters chained steps (each step's
    parameters are the last's less 1e-8 times its gradients) by CUDA
    events, the first repetition discarded and the median of the rest
    reported;
  * prints the table and the heavy workload's best variant, and one JSON
    line last (the JAX tool's --out payload with `device`, the card's name
    and power limit), which --out also writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.tools import bench, timing

VARIANTS = (
    ("scatter", "dense"),
    ("sorted_mxu", "dense"),
    ("scatter", "compact"),
    ("sorted_mxu", "compact"),
)
CHAIN = 1e-8
PARITY_TOL = 1e-4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed repetitions after the discarded first one")
    ap.add_argument("--out", default=None, help="write the results JSON here")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"
    log(f"device: {card}")
    order_rng = np.random.default_rng(0)

    results = {}
    for scale, name in ((0.088, "calibrated"), (0.15, "heavy")):
        state, cam, rcfg, gt, bg, make_fwd_bwd = bench.make_workload(scale, device=dev)
        log(f"[{name}] P={rcfg.max_intersections(state.capacity)} K={rcfg.max_per_tile}")
        configs = {f"{rb}/{bl}": dataclasses.replace(rcfg, reduce_backend=rb, bwd_layout=bl)
                   for rb, bl in VARIANTS}
        bench.check_kernels(state, list(configs.values()))
        steps = {v: make_fwd_bwd(c) for v, c in configs.items()}
        _, ref = steps["scatter/dense"](state)
        for v in list(steps)[1:]:
            bench.gate(f"{name} {v}", steps[v](state)[1], ref, PARITY_TOL)
        log(f"  parity ok (normalised gradient difference < {PARITY_TOL}, all variants)")
        del ref
        samples = bench.ab_times(steps, state, args.iters, args.reps, order_rng, CHAIN)
        for v, ms in samples.items():
            med = float(np.median(ms))
            results[f"{name}/{v}"] = dict(
                ms_per_step_median=round(med, 3),
                ms_per_step_samples=[round(s, 3) for s in ms],
                mpix_s=round(bench.mpix(med), 3))
            log(f"  MEDIAN {v:22s} {med:8.2f} ms/step  {bench.mpix(med):7.2f} Mpix/s")
        del state, steps

    heavy = {k: r["ms_per_step_median"] for k, r in results.items() if k.startswith("heavy/")}
    best = min(heavy, key=heavy.get)
    log(f"\nheavy-step best: {best.removeprefix('heavy/')} at {heavy[best]:.2f} ms "
        f"({heavy['heavy/scatter/dense'] - heavy[best]:+.2f} ms vs scatter/dense) [{card}]")
    payload = {
        "methodology": "chained iters; all variants precompiled; "
                       f"{args.reps} reps after 1 discarded, order shuffled per rep; "
                       "median reported",
        "iters_per_sample": args.iters,
        "table": results,
        "device": card,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
        log(f"wrote {args.out}")
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
