"""kernels_per_step: the device kernels the traced window launched (copies
and fills left out), over its steps."""


def read(ctx):
    if not ctx["kernels"] or ctx["steps"] <= 0:
        return None
    return len(ctx["kernels"]) / ctx["steps"]
