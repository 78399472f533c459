"""Reading torch.profiler traces of the benchmark's traced windows.

The per-layer metrics come from a window traced with the device's activity
alone (`device_record`): the host's own tracing would slow the host-paced
steps it measures several fold. A short second window traced with the
host's operations too names the device's idle gaps (`idle_gaps`).

  * `device_record(prof, window_s)` -> the device's busy seconds (the union
    of every device operation's interval: kernels, copies and fills), the
    kernels as (name, seconds), and the device operations that took most
    time;
  * `idle_gaps(prof)` -> the longest idle gaps of the device, each named by
    the innermost host operation running in its middle, or by the one that
    ended last before it ("after ...");
  * `device_ms_by_span(prof, steps, spans)` -> the device milliseconds a
    step under each of the program's spans (host operations named one of
    `spans`), in a window traced with the host's operations and the
    device's. The reduction is the program's
    (opengaussian_tpu_torch/utils/trace.py:device_ops), copied here so that
    a later change to the program cannot change how its spans are read;
    the benchmark takes only the spans' names from the program.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict

TOP = 10
UNPLACED = "unplaced"
BACKWARD = "backward"  # the program's span around the autograd engine's call
# the name of the profiler's record of a backward node's evaluation
NODE = "autograd::engine::evaluate_function: "


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _device_events(prof):
    from torch.autograd import DeviceType

    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_record(prof, window_s: float) -> dict:
    busy, end, by_name = 0.0, -math.inf, {}
    dev = _device_events(prof)
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
    kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e6)
               for e in dev if _is_kernel(e.name)]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy / 1e6, window_s=window_s, kernels=kernels,
                device_ops=[[k[:120], v] for k, v in top])


def idle_gaps(prof) -> list:
    from torch.autograd import DeviceType

    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    gaps, end = [], -math.inf
    for e in _device_events(prof):
        if end > -math.inf and e.time_range.start > end:
            gaps.append((e.time_range.start - end, end, e.time_range.start))
        end = max(end, e.time_range.end)

    def host_at(ts: float) -> str:
        """The innermost host operation running at ts, else "after" the one
        that ended last before it (the host in Python between operations)."""
        inner, before = None, None
        for h in host:
            r = h.time_range
            if r.start <= ts <= r.end and (inner is None or r.start >= inner.time_range.start):
                inner = h
            elif r.end < ts and (before is None or r.end > before.time_range.end):
                before = h
        if inner is not None:
            return inner.name
        return "after " + before.name if before is not None else "(no host operation)"

    gaps.sort(reverse=True)
    return [[host_at(0.5 * (a + b))[:120], g / 1e6] for g, a, b in gaps[:TOP]]


def _is_launch(e) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cudaMemcpyAsync, cuLaunchKernel, ...)."""
    return e.name.startswith("cu") and "::" not in e.name


def span_ops(prof, spans, host_stand_in: bool = False) -> list[tuple[str, str, float]]:
    """Each device operation of prof's trace (kernels, copies and fills) as
    (span, name, microseconds), put to a span:
      * to the innermost span open around the host call that launched it
        (the runtime's launch, which shares the operation's correlation id);
      * a kernel launched by a backward node of the autograd engine, which
        runs on the engine's own thread outside the caller's spans, to the
        span of the forward operation the node was recorded for (the node's
        sequence_nr and fwd_thread), unless a span is open inside the node;
      * what is still unplaced but was launched while a BACKWARD span was
        open (the engine's seed gradient, its zero fills) to BACKWARD;
      * the rest to UNPLACED.
    A trace with no device track gives nothing, so that no host time is read
    as the device's; with host_stand_in (a rehearsal on the CPU alone), each
    host operation that contains no other stands for a device operation."""
    from torch.autograd import DeviceType

    spans = set(spans)
    events = list(prof.events())
    host = [e for e in events if e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not e.is_user_annotation and e.name not in spans
              and not e.name.startswith("ProfilerStep")]
    launch = {e.id: e for e in host if _is_launch(e)}
    forward = {}
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.sequence_nr >= 0 and not e.name.startswith(NODE):
            forward.setdefault((e.thread, e.sequence_nr), e)
    backward = sorted((e.time_range.start, e.time_range.end) for e in host
                      if e.name == BACKWARD)
    starts = [s for s, _ in backward]

    def is_span(e) -> bool:
        return e.name in spans and e.device_type == DeviceType.CPU

    def span_of(e, depth: int = 0):
        while e is not None:
            if is_span(e):
                return e.name
            if e.name.startswith(NODE) and depth < 4:
                fwd = forward.get((e.fwd_thread, e.sequence_nr))
                return (span_of(fwd, depth + 1) if fwd is not None else None) or BACKWARD
            e = e.cpu_parent
        return None

    def in_backward(t: float) -> bool:  # backward spans do not overlap
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= backward[i][1]

    if device:
        ops = [(launch.get(k.id), k) for k in device]
    elif host_stand_in:
        ops = [(e, e) for e in host if not e.cpu_children and not is_span(e)]
    else:
        ops = []
    out = []
    for at, e in ops:
        name = span_of(at) if at is not None else None
        if name is None:
            t = at.time_range.start if at is not None else e.time_range.start
            name = BACKWARD if in_backward(t) else UNPLACED
        out.append((name, e.name, e.time_range.end - e.time_range.start))
    return out


def device_ms_by_span(prof, steps: int, spans,
                      host_stand_in: bool = False) -> dict[str, float]:
    """The device milliseconds a step under each span (`span_ops`), with
    UNPLACED, largest first; empty on a trace with no device track, unless
    host_stand_in."""
    by = defaultdict(float)
    for name, _op, us in span_ops(prof, spans, host_stand_in):
        by[name] += us / 1e3 / steps
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))
