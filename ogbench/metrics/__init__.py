"""Per-layer metric readers, one module per metric, found by the metric's
name in BENCHMARK.json. Each has `read(ctx) -> float | None`, where ctx is
the traced window's record (see ogbench/run.py:traced_window and
count_steps): the device record, the program's "spans" (device ms a step
by span) and "counters" (the trainer's slot counters over the traced
steps), and the counts. A reader that finds nothing to read returns None,
and the metric is left out."""

from __future__ import annotations


def span_ms(ctx, names) -> float | None:
    """The device ms a step under the program's spans `names` together: None
    where the trace has no device track or none of them ran on the
    device."""
    spans = ctx.get("spans")
    if not spans or not any(n in spans for n in names):
        return None
    return sum(spans.get(n, 0.0) for n in names)
