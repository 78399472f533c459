"""blend_ms: the device milliseconds a step under the program's `blend`,
`blend.bwd` and `reduce` spans (the forward blend K1 with its row gather
and untile, the backward K2 with its glue, the per-splat reduce K3), over
the traced run's host window."""

from ogbench.metrics import span_ms


def read(ctx):
    return span_ms(ctx, ("blend", "blend.bwd", "reduce"))
