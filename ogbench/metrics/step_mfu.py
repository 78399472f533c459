"""step_mfu: the fp32 operations a traced step needs (ogbench/counts.py:
step_ops, from each step's view, averaged over the traced steps), over the
wall time of an untraced step (run.py:traced_window) times the card's fp32
peak, in %."""


def read(ctx):
    if not ctx["works"] or not ctx["step_s"] or not ctx["peak_flops"]:
        return None
    return 100.0 * ctx["step_ops"] / len(ctx["works"]) / (ctx["step_s"] * ctx["peak_flops"])
