"""Device idle a request, in ms, while the innermost of the program's
spans is a `model.*` one: the device waiting on the forward's launches
(`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "dispatch")
