"""The arithmetic of the readers of the port's own spans
(``g2o_frontend_tpu_torch.utils.profiling.spans``, recorded while the
traced window's profiler records): intervals, their union, intersection
and difference, a span's self time by its children, the device's idle
time inside spans and by innermost span, and the trace's events inside
spans. An interval is (start ns, end ns); a union is a sorted list of
disjoint intervals. Spans and the trace's events share one clock, the
profiler's host clock (``CLOCK_REALTIME``).
"""
from __future__ import annotations

import bisect

# the runtime's calls that block the host until the stream or the device
# has finished (torch ends every copy to or from pageable memory in a
# stream synchronise: `.cpu()`, `.item()`, an upload)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                   "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"})


def program_spans():
    """The port's recorded spans, or None where it recorded none or has no
    recorder (a program older than the spans)."""
    try:
        from g2o_frontend_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() or None) if read is not None else None


def intervals(spans, name):
    """The (start, end) of the spans called `name`."""
    return [(s.start_ns, s.end_ns) for s in spans if s.name == name]


def is_sync(name):
    """Whether a runtime call (its name as the trace gives it, with any
    ``_ptsz``-like suffix) blocks the host: one of `SYNCS`."""
    return name.split("_", 1)[0] in SYNCS


def union(intervals):
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def length(u):
    return sum(t1 - t0 for t0, t1 in u)


def intersect(a, b):
    """The intersection of two unions."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        t0, t1 = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t0 < t1:
            out.append((t0, t1))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def complement(u, lo, hi):
    """What `u` leaves uncovered of [lo, hi]."""
    out, at = [], lo
    for t0, t1 in u:
        if t0 > at:
            out.append((at, min(t0, hi)))
        at = max(at, t1)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if a < b]


def minus(a, b):
    """What of the union `a` the union `b` leaves uncovered."""
    return intersect(a, complement(b, a[0][0], a[-1][1])) if a else []


def busy(device):
    """The union of the trace's device activities (name, start, end)."""
    return union((t0, t1) for _, t0, t1 in device)


def children(spans):
    """{span id: [its direct children]}."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def self_ns(span, kids, counted=lambda s: True):
    """`span`'s duration less the part of it that its `counted` children
    cover."""
    inner = union((max(k.start_ns, span.start_ns), min(k.end_ns, span.end_ns)) for k in kids if counted(k))
    return (span.end_ns - span.start_ns) - length(inner)


def top(spans):
    """The spans opened with no span around them."""
    ids = {s.id for s in spans}
    return [s for s in spans if s.parent not in ids]


def idle_in(u, device):
    """Device idle ns inside the union `u`: each gap in the device's busy
    union counts for the time it lies inside `u`, not by the span open at
    the gap's start."""
    return length(u) - length(intersect(u, busy(device)))


def covered(u, a, b):
    """ns of [a, b] that the union `u` covers."""
    k = max(bisect.bisect_right(u, (a, a)) - 1, 0)
    n = 0
    while k < len(u) and u[k][0] < b:
        n += max(0, min(u[k][1], b) - max(u[k][0], a))
        k += 1
    return n


def idle_by_innermost(spans, device, lo, hi):
    """{innermost span name, or "outside the program": device idle ns}
    over [lo, hi]: each stretch of idle time goes to the span opened last
    among those open then (spans of one thread nest)."""
    idle = complement(busy(device), lo, hi)
    edges = sorted({t for s in spans for t in (s.start_ns, s.end_ns) if lo < t < hi} | {lo, hi})
    opened = sorted(spans, key=lambda s: (s.start_ns, s.id))
    out: dict = {}
    k, stack = 0, []
    for a, b in zip(edges, edges[1:]):
        while k < len(opened) and opened[k].start_ns <= a:
            stack.append(opened[k])
            k += 1
        stack = [s for s in stack if s.end_ns > a]
        n = covered(idle, a, b)
        if n:
            name = stack[-1].name if stack else "outside the program"
            out[name] = out.get(name, 0) + n
    return out


def holders(events, within, slack_ns=0):
    """For each event (name, start, end), the interval of `within` (which
    do not overlap: one thread's spans of one name) in which the event
    starts, within `slack_ns` at either end, or None."""
    ivs = sorted(within)
    starts = [t0 for t0, _ in ivs]
    out = []
    for _, t0, _ in events:
        k = bisect.bisect_right(starts, t0 + slack_ns) - 1
        out.append(ivs[k] if k >= 0 and t0 <= ivs[k][1] + slack_ns else None)
    return out


def inside(events, spans, name, slack_ns=0):
    """The share of `events` (name, start, end) that lie inside a span
    called `name`, within `slack_ns` at either end; None without events."""
    if not events:
        return None
    held = holders(events, intervals(spans, name), slack_ns)
    return sum(h is not None and e[2] <= h[1] + slack_ns for e, h in zip(events, held)) / len(events)
