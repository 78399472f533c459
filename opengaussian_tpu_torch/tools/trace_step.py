"""Trace the bench's forward+backward step under torch.profiler and print
its per-kernel phase table (the port's counterpart of the JAX repo's
tools/trace_step.py).

    python -m opengaussian_tpu_torch.tools.trace_step [--heavy]
        [--reduce scatter|sorted_mxu] [--layout dense|compact] [--iters 3] [--top 15]

It builds tools/bench.py's workload (`make_workload`, scale 0.088, or 0.15
with --heavy), holds the step's kernels against their plain versions
(`bench.check_kernels`), warms the step up, then traces --iters chained steps (each
step's parameters are the last's less 1e-8 times its gradients, so that no
two steps see the same inputs) and prints:
  * the total device time per step (the sum of the kernels' times), the
    device's busy time (the union of their intervals), the host's wall time
    and the device's idle share, 1 - busy / wall;
  * a phase table: each kernel under the program span that launched it
    (utils/trace.py:device_ops: geometry, bin, blend, blend.bwd, reduce,
    loss, backward, each with its backward), and a kernel outside every
    span under the phase its name gives (`phase_of`): projection and
    binning, sort, K1 (and K5), the replay (K2, K4, K6), K3, SSIM and
    loss, cuBLAS's products, Adam, and other;
  * the --top kernels by mean ms per step and their share of the total;
then one JSON line with the same. On the CPU (device="cpu", the tests) the
profiler has no device track, and the table holds the CPU operators' self
time, as the JAX tool falls back to the host's XLA threads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict

import torch

from opengaussian_tpu_torch.device import resolve_device
from opengaussian_tpu_torch.tools import bench, timing
from opengaussian_tpu_torch.utils.trace import UNPLACED, device_ops

CHAIN = 1e-8  # p <- p - CHAIN * g between the traced steps
# (phase, name fragments), first match wins, on the lower-cased kernel name
PHASES = (
    ("K1/K5 forward blend", ("blend_stream_fwd", "blend_tiles_fwd")),
    ("K2/K4/K6 replay", ("blend_stream_bwd", "blend_tiles_bwd")),
    ("K3 per-splat reduce", ("segment_reduce",)),
    ("sort", ("sort",)),
    # cuDNN's and torch's convolutions by name ("conv" alone also names
    # dtype conversions), and the losses' own operators on the CPU
    ("SSIM and loss", ("convolution", "convolve", "conv2d", "conv_depthwise", "cudnn",
                       "fprop", "dgrad", "wgrad", "l1_loss", "mse")),
    # cuBLAS's kernels: the products of the projection (world to camera),
    # of the SH evaluation (a per-splat einsum) and of the port's SSIM (a
    # banded matrix product, ops/ssim.py), and their gradients
    ("cuBLAS products (projection, SH, SSIM)", ("gemm", "gemv", "matmul", "bmm")),
    ("Adam", ("adam", "_foreach")),
    ("projection and binning", ("gather", "scatter", "index", "cumsum", "searchsorted",
                                "nonzero", "devicescan", "catarray", "cat_", "unique",
                                "arange")),
)


def phase_of(name: str) -> str:
    """The phase a kernel (or, on the CPU, an operator) belongs to by its
    name: the port's kernels (csrc/*.cu) by their entry names, torch's by
    what they do; "other" where the name places nothing."""
    low = name.lower()
    for phase, keys in PHASES:
        if any(k in low for k in keys):
            return phase
    return "other"


def trace(fn, n: int, device: torch.device, what: str) -> dict:
    """n calls of fn under torch.profiler. -> {"kernels": {name: ms per
    call}, "ops": {(span, name): ms per call}, "busy_ms", "wall_ms",
    "launches"}: on a GPU the device's kernels (`timing.profile`), on the
    CPU the operators that contain no other."""
    if device.type == "cuda":
        counts: dict = {}
        busy, wall = timing.profile(fn, n, what, counts)
        return dict(kernels={k: ms for k, (ms, _c) in counts["kernels"].items()},
                    ops=counts["ops"], busy_ms=busy, wall_ms=wall,
                    launches=counts["launches"])
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels, ops, count = defaultdict(float), defaultdict(float), 0
    for op in device_ops(prof):
        kernels[op.name] += op.us / 1e3 / n
        ops[op.span, op.name] += op.us / 1e3 / n
        count += 1
    return dict(kernels=dict(kernels), ops=dict(ops), busy_ms=sum(kernels.values()),
                wall_ms=wall, launches=round(count / n))


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--heavy", action="store_true",
                    help="the r1-heavy workload (scale 0.15)")
    ap.add_argument("--reduce", default=None, choices=[None, "scatter", "sorted_mxu"],
                    help="override the per-splat reduce")
    ap.add_argument("--layout", default=None, choices=[None, "dense", "compact"],
                    help="override the backward layout (dense = K2, compact = K4)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    card = timing.smi() if dev.type == "cuda" else "cpu"

    scale = 0.15 if args.heavy else 0.088
    state, cam, rcfg, gt, bg, make_fwd_bwd = bench.make_workload(scale, device=dev)
    if args.reduce:
        rcfg = dataclasses.replace(rcfg, reduce_backend=args.reduce)
    if args.layout:
        rcfg = dataclasses.replace(rcfg, bwd_layout=args.layout)
    workload = dict(scale=scale, P=rcfg.max_intersections(state.capacity), K=rcfg.max_per_tile,
                    reduce=rcfg.resolved_reduce_backend(), layout=rcfg.bwd_layout)
    print(f"workload: {workload} [{card}]", file=sys.stderr, flush=True)
    bench.check_kernels(state, [rcfg])
    step = bench.Chain(make_fwd_bwd(rcfg), state, CHAIN)
    step()  # warm-up
    res = trace(step, args.iters, dev, "traced step")

    kernels = sorted(res["kernels"].items(), key=lambda kv: -kv[1])
    total = sum(ms for _, ms in kernels)
    idle = 1.0 - res["busy_ms"] / res["wall_ms"]
    print(f"\ntotal device time: {total:.3f} ms/step ({args.iters} steps traced); busy "
          f"{res['busy_ms']:.3f} of {res['wall_ms']:.3f} ms wall, idle share {idle:.3f}, "
          f"{res['launches']} launches/step [{card}]", file=sys.stderr)
    phases = defaultdict(float)
    for (span, name), ms in res["ops"].items():
        phases[phase_of(name) if span == UNPLACED else span] += ms
    phases = dict(sorted(phases.items(), key=lambda kv: -kv[1]))
    print("\nphase table:", file=sys.stderr)
    for phase, ms in phases.items():
        print(f"  {phase:38s} {ms:8.3f} ms  {ms / total * 100:5.1f}%", file=sys.stderr)
    top = [[name, ms, ms / total] for name, ms in kernels[:args.top]]
    print(f"\ntop {args.top} kernels:", file=sys.stderr)
    for name, ms, share in top:
        print(f"  {name[:64]:64s} {ms:8.3f} ms  {share * 100:5.1f}%", file=sys.stderr)
    out = dict(workload=workload, iters=args.iters, device_ms_per_step=total,
               busy_ms=res["busy_ms"], wall_ms=res["wall_ms"], idle_share=idle,
               launches_per_step=res["launches"], phases=phases, top=top, device=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
