"""loss_ms: the device milliseconds a step under the program's `loss`
span, its backward included, over the traced run's host window."""

from ogbench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, ("loss",))
