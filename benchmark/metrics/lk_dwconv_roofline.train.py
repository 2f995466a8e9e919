"""Kernel A (forward and input gradient) in a training step: its launches'
bounds over their device time, in %."""


def read(ctx):
    return ctx.roofline("lk_dwconv")
