"""blend_fwd_roofline: the forward blend kernel's (K1,
blend_stream_fwd_kernel) least time over the traced steps (ogbench/counts.py:
fwd_cost of each step's view, against the card's peaks) over its device time
in the trace, in %. Nothing to read where the trace holds no such kernel."""

KERNEL = "blend_stream_fwd_kernel"


def read(ctx):
    t = sum(s for name, s in ctx["kernels"] if KERNEL in name)
    if t <= 0 or not ctx["works"]:
        return None
    return 100.0 * ctx["fwd_bound_s"] / t
