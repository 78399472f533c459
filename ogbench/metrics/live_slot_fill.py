"""live_slot_fill: the trainer's own slot counters over the traced steps
(run.py:traced_window, "counters": the change of `Trainer.counters` over
the device-only call): the live slots (each binning's slots less those
dropped past the budget and truncated past max_per_tile) over the padded
streams P, in %. Nothing to read where no binning was counted."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not c.get("padded"):
        return None
    return 100.0 * c["live"] / c["padded"]
