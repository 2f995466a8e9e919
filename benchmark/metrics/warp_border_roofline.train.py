"""Kernel D (the loss warp, forward and coordinate gradient) in a
training step: its launches' bounds over their device time, in %."""


def read(ctx):
    return ctx.roofline("warp_border")
