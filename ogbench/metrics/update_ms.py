"""update_ms: the device milliseconds a step under the program's `update`
span, its backward included, over the traced run's host window."""

from ogbench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, ("update",))
