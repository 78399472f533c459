"""The measuring helpers of the port's tools and chip_smoke.py.

  * `smi`: the card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; every figure a tool prints carries it.
  * `cuda_ms`: milliseconds per call by CUDA events after warm-up.
  * `profile`: torch.profiler over n calls: the device's busy time (the
    union of the kernels' intervals), the host's wall time, the launches per
    call and each kernel's time, from which the idle share follows
    (1 - busy / wall).
  * `device_ms`: the device time of named kernels per call, corrected for
    the launches the profiler misses.
  * the bounds: the least time a blend kernel (K1, K2, K4, K5, K6) or a
    reduce (K3) could take on this card, the larger of the bytes it must
    move over the memory rate and the fp32 operations its data needs over
    the fp32 rate (`PEAKS`, by H100 model), with the operation counts per
    (slot, pixel) pair `OPS_*`.

Each helper logs its lines through `log`, to `LOG` (standard error unless a
caller sets another stream: chip_smoke.py logs to standard output). On the
CPU only `smi` (which needs nvidia-smi) and the profiler's device times are
missing; `cuda_ms` needs a GPU.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from collections import defaultdict

import torch

from opengaussian_tpu_torch.utils.trace import device_ops

LOG = None  # the stream log writes to; None: standard error


def log(*a):
    print(*a, file=LOG if LOG is not None else sys.stderr, flush=True)


# fp32 operations per (slot, pixel) pair of the blend, by what the pair needs:
# every pair that must be evaluated (its warp's pixels meet the slot's cull
# box; outside it alpha stays below 1/255, which one test per warp shows):
# dx, dy and the conic's quadratic form (11), the clamp of power (1), expf
# (~8: range reduction, ex2 and scaling without fast math), the power test,
# o * gauss, the 0.99 clamp and the 1/255 test (4)
OPS_EVALUATED = 24
OPS_TESTED = 3  # alpha >= 1/255: 1 - alpha, T * (1 - alpha), the 1e-4 test
OPS_CULL = 4  # per slot and warp: the warp's rectangle against the box
# per staged slot, its cull box (blend_tile.cuh:slot_box): det (3), the
# conditioning bound (7), the tests (5), the level with its log (13), the
# half-extents (8), their margins (12), the edges (4), finiteness (4), the
# opacity test (1)
OPS_BOX = 57


def ops_blended(C: int) -> int:
    """A pair that composites: w = alpha * T, then a multiply-add per channel."""
    return 1 + 2 * C


def ops_grad(C: int) -> int:
    """A pair that composites, in the backward replay: w (1), gc (2C - 1),
    the running sum (2), 1 - a floored (2), d_alpha (6), the clamp test (1),
    d_power (1), the mean2d, conic and opacity terms (18), the payload terms
    (C) and its share of the sum over the tile's pixels (6 + C)."""
    return 4 * C + 36


# NVIDIA data sheets: fp32 (non-tensor) FLOP/s and HBM bytes/s per H100 model
PEAKS = (("PCIe", 51e12, 2.0e12), ("NVL", 60e12, 3.9e12),
         ("", 67e12, 3.35e12))  # "" = SXM, what "H100 80GB HBM3" names


def peaks(name: str) -> tuple[float, float]:
    """(fp32 FLOP/s, HBM bytes/s) of the H100 model `name`
    (torch.cuda.get_device_name)."""
    return next((f, b) for key, f, b in PEAKS if key in name)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of fn on the current stream."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def step_ms(fn, iters: int, device, warmup: int = 1) -> float:
    """Milliseconds per call of fn after warm-up: `cuda_ms` on a GPU, the
    host clock on the CPU (where the tools run at their small sizes)."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def profile(fn, n: int, what: str, counts: dict | None = None) -> tuple[float, float]:
    """torch.profiler over n calls of fn: device time by kernel.
    -> (device busy ms per call, the union of the kernels' intervals; host
    wall ms per call of the same profiled calls, to the last kernel's end).
    counts: receives "launches", the kernels per call, "span_ms", first
    kernel start to last kernel end per call, "kernels", {name: (ms per
    call, launches per call)} over every kernel the calls launched, and
    "ops", {(span, name): ms per call}, each device operation put to its
    program span (utils/trace.py:device_ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end, by_name = 0.0, -math.inf, {}
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + (t - s), k + 1)
    busy_ms = busy / 1e3 / n
    span_ms = (end - kernels[0].time_range.start) / 1e3 / n
    if counts is not None:
        ops = defaultdict(float)
        for op in device_ops(prof):
            ops[op.span, op.name] += op.us / 1e3 / n
        counts["ops"] = dict(ops)
        counts["launches"] = round(len(kernels) / n)
        counts["span_ms"] = span_ms
        counts["kernels"] = {k: (us / 1e3 / n, c / n) for k, (us, c) in by_name.items()}
    log(f"profile {what}: device busy {busy_ms:.3f} ms, first kernel start to last "
        f"kernel end {span_ms:.3f} ms, host wall {wall_ms:.3f} ms, "
        f"{len(kernels) / n:.0f} kernel launches (per {what})")
    for k, (us, _c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"profile {what}:   {us / 1e3 / n:8.4f} ms  {k[:90]}")
    return busy_ms, wall_ms


def device_ms(fn, n: int, *names: str) -> float:
    """Device time per call of the kernels whose names hold one of `names`,
    by torch.profiler over n calls: the kernels alone, without the host work
    of their wrapper. Each name's time is its mean over the launches the
    profiler recorded (it can miss one of a window, and now and then a
    whole window, which is then profiled again, up to 3 times), times its
    launches per call. With no names, every kernel the calls launch, each
    by its own name in the same way (a plain sum of the recorded events
    would drop the launches the profiler missed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events and all(any(name in e.name for e in events) for name in names):
            break
        log(f"profile: a window of {n} calls recorded none of {names or 'its kernels'}; "
            "profiling again")
    if names:
        groups = {name: [e for e in events if name in e.name] for name in names}
    else:
        groups = {}
        for e in events:
            groups.setdefault(e.name, []).append(e)
    total = 0.0
    for name, evs in groups.items():
        us = [e.time_range.end - e.time_range.start for e in evs]
        if not us:
            raise AssertionError(f"the profiler recorded no {name}")
        per_call = max(1, round(len(us) / n))
        if len(us) != per_call * n:
            log(f"profile: {len(us)} {name[:60]} launches recorded of {n} calls")
        total += sum(us) / len(us) * per_call / 1e3
    return total


def walk_ops(work) -> int:
    """The operations a tile walk needs before any compositing, from the
    plain version's work counts: a cull box per staged slot, a box test per
    slot and warp, the evaluation of each pair in a box, the transmittance
    test of each pair past 1/255."""
    return (work["boxes"] * OPS_BOX + work["box_tests"] * OPS_CULL
            + work["in_box"] * OPS_EVALUATED + work["tested"] * OPS_TESTED)


def bound_of(name, moved, ops, peak_flops, peak_bytes) -> tuple[float, str]:
    t_bytes, t_ops = moved / peak_bytes * 1e3, ops / peak_flops * 1e3
    log(f"bound: {name}: {moved} bytes -> {t_bytes:.4f} ms, {ops} ops -> {t_ops:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fwd_bound(name, live: int, F: int, T: int, n_index: int, work, peak_flops,
              peak_bytes) -> tuple[float, str]:
    """A forward blend's least time per launch (K1, K5): the larger of the
    bytes moved over the HBM rate (each of the `live` slot rows read once,
    n_index [T] int32 tables, accum and t_final written once) and the
    operations this frame's data needs (from the plain version's work
    counts) over the fp32 rate."""
    C = F - 6
    moved = live * F * 4 + n_index * T * 4 + T * 256 * C * 4 + T * 256 * 4
    ops = walk_ops(work) + work["blended"] * ops_blended(C)
    return bound_of(name, moved, ops, peak_flops, peak_bytes)


def bwd_bound(name, live: int, F: int, T: int, n_index: int, work, peak_flops,
              peak_bytes) -> tuple[float, str]:
    """A backward replay's (K2, K6): the live rows read and their gradient
    rows written once, n_index [T] int32 tables, accum/g_accum/t_final/g_t
    read once; the replay's operations from its own pair counts."""
    C = F - 6
    moved = 2 * live * F * 4 + n_index * T * 4 + 2 * T * 256 * (C + 1) * 4
    ops = walk_ops(work) + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1)
    return bound_of(name, moved, ops, peak_flops, peak_bytes)


def compact_bound(live: int, nc_rows: int, rows: int, F: int, T: int, work, peak_flops,
                  peak_bytes) -> tuple[float, str]:
    """K4: the live rows and their splat ids read once, the rows of the
    tiles' range written once (nc_rows), every id of the output written once
    (rows), the [T] counts, tstart, toff and cstart tables,
    accum/g_accum/t_final/g_t read once; the replay's operations from its
    pair counts, as K2's."""
    C = F - 6
    moved = (live * (F + 1) * 4 + nc_rows * F * 4 + rows * 4 + 4 * T * 4
             + 2 * T * 256 * (C + 1) * 4)
    ops = walk_ops(work) + work["blended"] * ops_grad(C) + T * 256 * (2 * C + 1)
    return bound_of("blend_stream_bwd_compact", moved, ops, peak_flops, peak_bytes)


def reduce_bound(d_rows, n, peak_flops, peak_bytes) -> tuple[float, str]:
    """K3: rows and ids read once, [n, F] written once; one add per element."""
    R, F = d_rows.shape
    return bound_of("segment_reduce", R * F * 4 + R * 4 + n * F * 4, R * F,
                    peak_flops, peak_bytes)


def perm_bound(d_rows, bins, n, peak_flops, peak_bytes) -> tuple[float, str]:
    """K3's permutation entry: rows, the [L] slot positions and the [n]
    range ends read once, [n, F] written once; one add per element."""
    R, F = d_rows.shape
    L = bins.slot_pos.shape[0]
    return bound_of("segment_reduce_perm", R * F * 4 + L * 4 + n * 4 + n * F * 4, R * F,
                    peak_flops, peak_bytes)
