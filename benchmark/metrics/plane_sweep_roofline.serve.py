"""Kernel C (the cost volume's per-bin differences) in a student request:
its launches' bounds over their device time, in %."""


def read(ctx):
    return ctx.roofline("plane_sweep")
