"""Blocking host syncs a map solve: the runtime's calls in the traced
window that block the host (`spans.SYNCS`: a stream, device or event
synchronise, a synchronous copy) and start inside one of the port's
``map_solve`` spans (`PwnSlam.solve`), over the solves: the graphs' reads
of their loops' tests and every eager read of the hierarchical solve."""

from perfbench import spans


def read(r):
    solves = spans.intervals(spans.program_spans() or (), "map_solve")
    if not solves:
        return None
    syncs = [e for e in r.trace.runtime if spans.is_sync(e[0])]
    return sum(h is not None for h in spans.holders(syncs, solves)) / len(solves)
