"""The device's idle time of a traced window put on the program's own
spans (`mlsp_tpu_torch.utils.profiling.span`), for the per-layer
readers of the trainer, train step, eval and serving layers.

The idle intervals are the times between the window's first and last
device operation in which no operation ran. Each is split over the
innermost program span open at each instant, the part under no program
span going to "outside", so the parts add up to the window's idle time.
(The harness's `trace._top_gaps` instead gives a whole gap to the
benchmark span it began in.) The spans' clock is the profiler's: both
carry Unix-epoch nanoseconds.

Where the program records no spans (a port whose `profiling` has no
`spans`, or an empty record), every function here returns None.
"""

from __future__ import annotations

OUTSIDE = "outside"
_last: list = []  # [reading, records read, window_split]


def program_spans() -> list | None:
    """The program's span records, `(name, start_ns, end_ns, parent)`, or
    None where it has none."""
    try:
        from mlsp_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "spans", lambda: None)()
    return records or None


def idle_intervals(ops) -> list[tuple[int, int]]:
    """The (start, end) ns in which no operation of `ops` ((name,
    start_ns, duration_ns), any order) ran, between the first's start and
    the last's end."""
    gaps, cursor = [], None
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        if cursor is not None and s > cursor:
            gaps.append((cursor, s))
        cursor = s + d if cursor is None else max(cursor, s + d)
    return gaps


def innermost(records) -> list[tuple[int, int, int | None]]:
    """(start, end, index) in time order: the innermost record open over
    [start, end) (the latest opened of those open), None under none.
    Records still open (end None) are left out."""
    events = []
    for i, (_, s, e, _) in enumerate(records):
        if e is not None and e > s:
            events += [(s, 1, i), (e, 0, i)]
    events.sort()
    segs, stack, closed, t = [], [], set(), None
    for at, opens, i in events:
        if t is not None and at > t:
            segs.append((t, at, stack[-1] if stack else None))
        t = at
        if opens:
            stack.append(i)
        else:
            closed.add(i)
            while stack and stack[-1] in closed:
                stack.pop()
    return segs


def split(ops, records) -> tuple[dict, int, int]:
    """(idle ns by record index, idle ns outside every record, all idle
    ns) of the device operations `ops` under the span `records`."""
    segs = innermost(records)
    by, inside, total, j = {}, 0, 0, 0
    for a, b in idle_intervals(ops):
        total += b - a
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            t0, t1, i = segs[k]
            part = min(b, t1) - max(a, t0)
            if i is not None and part > 0:
                by[i] = by.get(i, 0) + part
                inside += part
            k += 1
    return by, total - inside, total


def window_split(ctx):
    """`split` of the traced window's operations under the program's
    spans, with the records: (records, by index, outside, total), or None
    where the program has no spans or the window no operations. Read once
    a window."""
    records = program_spans()
    if records is None or not ctx.reading.ops:
        return None
    if not (_last and _last[0] is ctx.reading and _last[1] == len(records)):
        _last[:] = [ctx.reading, len(records),
                    (records, *split(ctx.reading.ops, records))]
    return _last[2]


def by_name(records, by: dict, outside: int) -> dict:
    """Idle ns by span name, "outside" included."""
    out = {OUTSIDE: outside}
    for i, ns in by.items():
        out[records[i][0]] = out.get(records[i][0], 0) + ns
    return out


def _under(records, i: int, names) -> bool:
    while i is not None:
        if records[i][0] in names:
            return True
        i = records[i][3]
    return False


def idle_ms(ctx, per: str, own=(), under=()) -> float | None:
    """Idle ms of the window a unit of `ctx.counts[per]` (steps, requests,
    calls) whose innermost span is named in `own` or lies in a span
    named in `under` (itself included); None without spans or units."""
    got, n = window_split(ctx), ctx.counts.get(per, 0)
    if got is None or not n:
        return None
    records, by, _, _ = got
    ns = sum(v for i, v in by.items()
             if records[i][0] in own or _under(records, i, under))
    return ns / 1e6 / n


def count(ctx, name: str) -> float | None:
    """The program's spans named `name` in the window; None without
    spans."""
    got = window_split(ctx)
    if got is None:
        return None
    return float(sum(1 for r in got[0] if r[0] == name))
