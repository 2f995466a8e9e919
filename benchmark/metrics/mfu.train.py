"""The training step's model FLOPs (forward and backward, the frozen set
excluded) over the window's time and the bf16 dense peak, in %."""


def read(ctx):
    return ctx.mfu()
