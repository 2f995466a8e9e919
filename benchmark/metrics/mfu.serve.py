"""A request's model FLOPs over the window's time and the bf16 dense
peak, in %."""


def read(ctx):
    return ctx.mfu()
