"""Device time a training step in batch norm and the other elementwise
kernels (the categories of `harness/trace.py`), in ms."""


def read(ctx):
    s = ctx.category_s("batch norm", "other elementwise")
    return 1e3 * ctx.per_unit(s) if s else None
