"""Per-layer metric readers, one module per metric, found by the metric's
name in BENCHMARK.json. Each has `read(ctx) -> float | None`, where ctx is
the traced window's record (see ogbench/run.py:traced_window); a reader
that finds nothing to read returns None, and the metric is left out."""
