"""Wall milliseconds a map solve: the mean duration of the port's
``map_solve`` spans (`PwnSlam.solve`: packing the map, the coarse and fine
SE3 solves, the rigid warp and the poses' read back)."""

from perfbench import spans


def read(r):
    ns = [s.end_ns - s.start_ns for s in spans.program_spans() or () if s.name == "map_solve"]
    return sum(ns) / len(ns) / 1e6 if ns else None
