"""Device kernels a training step launches (memory copies and sets left
out), over the traced steps."""


def read(ctx):
    return ctx.summary.kernels / ctx.summary.units
