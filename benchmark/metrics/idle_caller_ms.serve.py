"""Device idle a request, in ms, while none of the program's spans is
open: the caller between requests (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "caller")
