"""slot_fill: the live slots of the traced steps' views (the (splat, tile)
pairs the blend walks, ogbench/counts.py:frame_work) over the slot stream
the program pads each step to (its budget P, read from the trainer), in %."""


def read(ctx):
    if not ctx["works"] or not ctx["slot_budget"]:
        return None
    live = sum(w["live"] for w in ctx["works"])
    return 100.0 * live / (len(ctx["works"]) * ctx["slot_budget"])
