"""Kernel 1 (`ops.fused_aligner`, ``fused_aligner_kernel`` of
``csrc/fused_aligner.cu``) as a share of its roofline: the least time of
every launch in the traced window at the card's published peaks
(`perfbench/roofline.py`), over the launches' device time, in percent.
Launches are found by the kernel's name."""

from perfbench import roofline


def read(r):
    cam = r.config["camera"]
    times = [t1 - t0 for name, t0, t1 in r.trace.device if roofline.is_kernel1(name)]
    if not times:
        return None
    bound_s = roofline.kernel1_bound_s(int(cam["rows"]), int(cam["cols"]))
    return 100.0 * len(times) * bound_s / (sum(times) / 1e9)
