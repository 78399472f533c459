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
    ended last before it ("after ...").
"""

from __future__ import annotations

import math

TOP = 10


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
