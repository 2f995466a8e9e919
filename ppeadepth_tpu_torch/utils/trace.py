"""Phase spans of the port, for a torch profiler's trace.

    with span("model.pose"):
        ...

While a torch profiler records, `span(name)` is a
`torch.profiler.record_function("ppea:" + name)` range: one of
kineto's own user annotations, so it sits on the profiler's clock beside
the operators and, on a card, is mirrored onto the stream over the device
work it launched. Otherwise it is one shared no-op context that calls
nothing of the profiler (about 1 us where an unguarded `record_function`
costs about 12 us on a CPU).

The spans mark phases only (a request, its upload and download, the pose
net, an encoder, the cost volume, a decoder, a training step's parts),
never a block or a kernel; nesting follows time on the calling thread.
Their readers: the benchmark's idle split (`benchmark/harness/spans.py`),
`chip_smoke.py --profile`'s phase lines, and an operator's own profile
(README, "Profiling the port").
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

PREFIX = "ppea:"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `ppea:<name>` range while a profiler records, else a no-op."""
    if torch.autograd._profiler_enabled():
        return record_function(PREFIX + name)
    return _OFF
