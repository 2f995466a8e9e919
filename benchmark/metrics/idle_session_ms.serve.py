"""Device idle a request, in ms, while the innermost of the program's
spans is a `serve.*` one: the session staging the frames
(`serve.upload`), waiting on and converting the depth (`serve.download`),
or running its own lines between those and the model's phases
(`serve.request` innermost) (`harness/spans.py`)."""

from harness import spans


def read(ctx):
    return spans.idle_ms(ctx, "session")
