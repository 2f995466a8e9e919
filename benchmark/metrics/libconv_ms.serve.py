"""Device time a request in cuDNN and cuBLAS convolutions and GEMMs, in
ms."""


def read(ctx):
    s = ctx.category_s("cuDNN and cuBLAS")
    return 1e3 * ctx.per_unit(s) if s else None
