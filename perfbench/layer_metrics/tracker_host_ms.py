"""The live tracker's own host milliseconds a frame: the mean self time
of the port's ``pwn_tracker.frame`` spans, each frame's duration less the
union of its ``stage:*`` and ``host_read`` children. What is left is the
tracker's pose arithmetic, map, keyframe cache, upload and Python."""

from perfbench import spans


def _counted(s):
    return s.name.startswith("stage:") or s.name == "host_read"


def read(r):
    rec = spans.program_spans()
    frames = [s for s in rec or () if s.name == "pwn_tracker.frame"]
    if not frames:
        return None
    kids = spans.children(rec)
    return sum(spans.self_ns(f, kids.get(f.id, []), _counted) for f in frames) / len(frames) / 1e6
