"""blend_bwd_roofline: the backward replay kernel's (K2,
blend_stream_bwd_kernel) least time over the traced steps (ogbench/counts.py:
bwd_cost of each step's view) over its device time in the trace, in %.
Nothing to read where the trace holds no such kernel."""

KERNEL = "blend_stream_bwd_kernel"


def read(ctx):
    t = sum(s for name, s in ctx["kernels"] if KERNEL in name)
    if t <= 0 or not ctx["works"]:
        return None
    return 100.0 * ctx["bwd_bound_s"] / t
