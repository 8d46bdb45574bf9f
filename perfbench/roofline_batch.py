"""Kernel 2's least time: the bytes and float32 operations of one launch of
``fused_aligner_batch_kernel`` (``csrc/fused_aligner.cu``) as functions of
the batch's K and the image's H x W, at the card's published peaks
(`roofline.py`).

One launch builds K Gauss-Newton systems of one current cloud against K
reference clouds. It reads the current cloud's 20 float32 planes once for
the batch, each candidate's 8-float reference row (point 3, normal 3,
curvature, validity) of every pixel it fetches and its 24 floats of
parameters, and writes its 29 sums. Each is counted once. The rows a
candidate fetches depend on the overlap of the two views: `rows` gives
their count where it is known; by default every pixel's row is counted,
the most one launch can need, as `roofline.kernel1_bytes` counts them.
The operations are kernel 1's per pixel (`roofline.OPS_PER_PIXEL`), for
each candidate.
"""
from __future__ import annotations

from .roofline import CUR_CHANNELS, F32_OPS_PER_S, HBM_BYTES_PER_S, OPS_PER_PIXEL, PARAMS, REF_CHANNELS, SUMS


def kernel2_bytes(k: int, rows: int, cols: int, fetched_rows: int | None = None) -> int:
    """Bytes of one launch at batch size `k` on `rows` x `cols` images;
    `fetched_rows`, the distinct reference rows the K candidates fetch,
    defaults to every pixel of every candidate."""
    pixels = rows * cols
    fetched = k * pixels if fetched_rows is None else fetched_rows
    return 4 * (pixels * CUR_CHANNELS + fetched * REF_CHANNELS + k * (PARAMS + SUMS))


def kernel2_ops(k: int, rows: int, cols: int) -> int:
    return k * rows * cols * OPS_PER_PIXEL


def kernel2_bound_s(k: int, rows: int, cols: int) -> float:
    """The larger of bytes over the memory's peak and operations over
    float32's peak, in seconds."""
    return max(kernel2_bytes(k, rows, cols) / HBM_BYTES_PER_S, kernel2_ops(k, rows, cols) / F32_OPS_PER_S)
