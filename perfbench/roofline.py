"""The card's published peaks and the least time of the kernels whose
roofline share the benchmark reports.

One NVIDIA H100 SXM, NVIDIA's data sheet: HBM3 at 3.35 TB/s and 67
TFLOP/s in float32 outside the tensor cores, at the full 700 W power
limit (the result's device line gives the card's name; its power limit is
printed beside every run).
"""
from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Kernel 1 reads the current cloud's 20 float32 planes (point 3, normal 3,
# curvature, validity, point information 6, normal information 6) and the
# reference cloud's 8-float table (point 3, normal 3, curvature, validity)
# of every pixel, and 24 floats of parameters; it writes the 29 sums. Each
# is counted once. The reference rows it fetches depend on the overlap of
# the two views; all of them are counted, the most one launch can need.
CUR_CHANNELS = 20
REF_CHANNELS = 8
PARAMS = 24
SUMS = 29
# float32 operations a pixel (the gather, the gates, the linearisation and
# its share of the 29 sums), counted from the kernel's source
OPS_PER_PIXEL = 360

_KERNEL1 = re.compile(r"(^|[^A-Za-z0-9_])fused_aligner_kernel([^A-Za-z0-9_]|$)")


def is_kernel1(name: str) -> bool:
    return bool(_KERNEL1.search(name))


def kernel1_bytes(rows: int, cols: int) -> int:
    return 4 * (rows * cols * (CUR_CHANNELS + REF_CHANNELS) + PARAMS + SUMS)


def kernel1_bound_s(rows: int, cols: int) -> float:
    """The larger of bytes over the memory's peak and operations over
    float32's peak, in seconds."""
    return max(kernel1_bytes(rows, cols) / HBM_BYTES_PER_S, rows * cols * OPS_PER_PIXEL / F32_OPS_PER_S)
