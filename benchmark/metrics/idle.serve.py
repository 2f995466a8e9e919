"""1 - (union of device intervals) / (traced span) over the traced
requests, in %."""


def read(ctx):
    return ctx.idle()
