"""The program's own phase spans in a traced run: the `ppea:` ranges the
port opens around a request, its upload and download, the pose net, the
encoders, the cost volume and the decoders
(`ppeadepth_tpu_torch/utils/trace.py`), read from the reduced trace that
every reader takes (`harness/trace.Summary`).

The profiler records each range on the calling thread and, on a card, a
device-side copy over the work it launched (a `gpu_user_annotation`).
`trace.events` drops that copy where kineto's events have no
`activity_type` (torch 2.11, the card's) and files it under
`Summary.host` where they have one (newer torch). A copy's ends are a
device event's start and a device event's end, and a host range's, on
the host's clock, are not: so the copies are told apart and left out,
and only host ranges are read.

The idle split takes the gaps that `Summary.gaps` and `idle.serve` take
(between device segments, each starting inside a `bench:` span) and
splits each one instant by instant by the innermost range open then, the
latest-started one (ranges nest on the calling thread): a gap that runs
from one request's download through the caller into the next request's
upload is shared by the three by overlap."""

from __future__ import annotations

from bisect import bisect_right

from .trace import SPAN

PREFIX = "ppea:"
# the innermost range's name prefix -> the part of the idle split; the
# session's part holds `serve.request` where it is innermost too: the
# session's own lines between its upload, the model's phases and its
# download
OWNERS = (("model.", "dispatch"), ("serve.", "session"))
CALLER = "caller"  # no range of the program open


def ranges(summary):
    """The program's host ranges as (name after `ppea:`, start_ns,
    end_ns), sorted by start; device-side copies left out."""
    starts = {s for _, s, _ in summary.device}
    ends = {e for _, _, e in summary.device}
    return sorted(((n[len(PREFIX):], s, e) for n, s, e in summary.host
                   if n.startswith(PREFIX)
                   and not (s in starts and e in ends)), key=lambda r: r[1])


def innermost(host):
    """[(start_ns, end_ns, name)] where some range is open, each piece
    named by the innermost range open over it."""
    points = sorted({t for _, s, e in host for t in (s, e)})
    pieces = []
    for p, q in zip(points, points[1:]):
        open_ = [(s, -e, n) for n, s, e in host if s <= p and e >= q]
        if open_:
            name = max(open_)[2]
            if pieces and pieces[-1][1] == p and pieces[-1][2] == name:
                pieces[-1] = (pieces[-1][0], q, name)
            else:
                pieces.append((p, q, name))
    return pieces


def owner(name: str) -> str:
    for prefix, part in OWNERS:
        if name.startswith(prefix):
            return part
    return name


def idle_gaps(summary):
    """(start_ns, end_ns) of the gaps between device segments that begin
    inside a harness span. The same selection as `trace.Summary.gaps`
    (which labels each gap instead of returning it): keep the two in step,
    as `test_bench_spans.py` checks by their totals."""
    spans = [(s, e) for n, s, e in summary.host if n.startswith(SPAN)]
    segs = summary.segments
    return [(a, b) for (_, a), (b, _) in zip(segs, segs[1:])
            if any(s <= a < e for s, e in spans)]


def idle_split(summary):
    """{part: idle seconds} over `idle_gaps`: "dispatch" where the
    innermost open range is a `model.*` one, "session" a `serve.*` one
    (`serve.request` included),
    "caller" where none is open, any other range under its own name; None
    where the trace holds no range of the program."""
    host = ranges(summary)
    if not host:
        return None
    pieces = innermost(host)
    starts = [s for s, _, _ in pieces]
    out = {}

    def add(part, ns):
        out[part] = out.get(part, 0.0) + ns / 1e9

    for a, b in idle_gaps(summary):
        covered = 0
        i = max(bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            ns = min(e, b) - max(s, a)
            if ns > 0:
                add(owner(name), ns)
                covered += ns
            i += 1
        add(CALLER, (b - a) - covered)
    return out


def idle_ms(ctx, part: str):
    """Device idle a unit in ms while the program was doing `part`; None
    where the trace holds no range of the program."""
    split = idle_split(ctx.summary)
    if split is None:
        return None
    return 1e3 * ctx.per_unit(split.get(part, 0.0))
