"""Blocking host syncs a live frame: the runtime's calls in the traced
window that block the host (`spans.SYNCS`: a stream, device or event
synchronise, a synchronous copy) and start inside one of the port's
``pwn_tracker.frame`` spans, over the frames. Every sync of a frame
counts, wherever in the tracker it sits: torch ends each copy to or from
pageable memory in one (`.cpu()`, `.item()`, the depth's upload)."""

from perfbench import spans


def read(r):
    frames = spans.intervals(spans.program_spans() or (), "pwn_tracker.frame")
    if not frames:
        return None
    syncs = [e for e in r.trace.runtime if spans.is_sync(e[0])]
    return sum(h is not None for h in spans.holders(syncs, frames)) / len(frames)
