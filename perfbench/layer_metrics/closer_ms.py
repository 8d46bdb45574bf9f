"""Wall milliseconds a closer call: the mean duration of the port's
``closer`` spans that ran at least one candidate batch (a
``closer:match`` span inside them): the cache's gets and recomputes, the
batch's match and host read, and the consensus."""

from perfbench import spans


def read(r):
    rec = spans.program_spans()
    if not rec:
        return None
    kids = spans.children(rec)
    calls = [s for s in rec if s.name == "closer" and any(k.name == "closer:match" for k in kids.get(s.id, ()))]
    return sum(s.end_ns - s.start_ns for s in calls) / len(calls) / 1e6 if calls else None
