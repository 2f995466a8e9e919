"""Device kernels a request launches (memory copies and sets left out),
over the traced requests."""


def read(ctx):
    return ctx.summary.kernels / ctx.summary.units
