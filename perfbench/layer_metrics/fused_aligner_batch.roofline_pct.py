"""Kernel 2 (`ops.fused_aligner`, ``fused_aligner_batch_kernel`` of
``csrc/fused_aligner.cu``) as a share of its roofline: the least time of
every launch in the traced window at the card's published peaks
(`perfbench/roofline_batch.py`, at the padded K of the ``closer:match``
span it was launched in), over the launches' device time, in percent.
Launches are found by the kernel's name (`drivers/pwn_slam._match_device`)."""

from perfbench import roofline_batch


def read(r):
    ks, ns = r.counters.get("kernel2_padded_k"), r.counters.get("kernel2_ns")
    if not ns:
        return None
    cam = r.config["camera"]
    bound_s = sum(roofline_batch.kernel2_bound_s(int(k), int(cam["rows"]), int(cam["cols"])) for k in ks)
    return 100.0 * bound_s / (sum(ns) / 1e9)
