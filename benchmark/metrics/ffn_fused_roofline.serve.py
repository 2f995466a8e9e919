"""Kernel B (the merged ConvFFN, up and down) in a request: its launches'
bounds over their device time, in %."""


def read(ctx):
    return ctx.roofline("ffn_fused")
