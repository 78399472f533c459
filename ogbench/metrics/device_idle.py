"""device_idle: the share of a step in which no operation ran on the card,
in %: 1 - (busy per traced step) / (wall time per untraced step). busy is
the union of the device operations' intervals in the profiler's trace; the
wall time is that of the run's untraced chunk (run.py:traced_window), since
the tracer itself slows a host-paced step."""


def read(ctx):
    if ctx["steps"] <= 0 or ctx["busy_s"] <= 0 or not ctx["step_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["steps"] / ctx["step_s"])
