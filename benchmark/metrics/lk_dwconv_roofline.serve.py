"""Kernel A in a request of the merged network: its launches' bounds over
their device time, in %."""


def read(ctx):
    return ctx.roofline("lk_dwconv")
