"""The share of the traced window in which the card was idle while the
program's host worked, in percent: 100 x the device's idle time inside
the port's top-level spans (a frame, a scan call, a solve) but outside
its ``launch`` spans, over the window. Idle is the complement of the
union of kernels, copies and fills, as `device_idle_pct` reads it; each
gap counts for the time it lies in that region. Left out: the idle time
inside a ``CUDAGraph.replay()``, where the trace's own cost for each of a
graph's kernels lands, and outside the program (the caller's loop, the
trace's stop). One reader for ``idle_program_pct.track`` and ``.schur``."""

from perfbench import spans


def read(r):
    rec = spans.program_spans()
    if not rec or not r.trace.device or r.window_s <= 0:
        return None
    program = spans.union((s.start_ns, s.end_ns) for s in spans.top(rec))
    host = spans.minus(program, spans.union(spans.intervals(rec, "launch")))
    return 100.0 * spans.idle_in(host, r.trace.device) / (r.window_s * 1e9)
