"""2D laser line extraction: clustering + split-merge, vectorized
(counterpart of ``g2o_frontend_tpu/laser/line_extraction.py``).

Re-design of ``line_extraction/line_extraction2d.{h,cpp}``
(`Point2DClusterer` + `Line2DExtractor` split/merge) and the
``SplitMergeEE`` family (``SplitMergeEE.h:11-21``). A scan is a fixed-length
masked array and the segmentation a per-point *breakpoint mask*; each round
treats every segment at once:

  1. cluster: breakpoints at range jumps (`Point2DClusterer::compute`),
  2. split (fixed rounds): per-segment chord endpoints by segment min/max,
     per-point chord distance, per-segment argmax; split where above the
     threshold,
  3. merge (fixed rounds): per-segment total-least-squares lines from
     segment moments and a closed-form 2x2 eigendirection; adjacent
     segments with compatible (normal, rho) merge
     (`Line2DExtractor::merge`),
  4. emit a fixed-capacity line set (endpoints, normal/rho, #points, mask).

The segment reductions are `scatter_reduce` (min and max, exact in any
order) and `ops.segment_sum` (the moments, in a fixed order) with the JAX
version's values for empty segments (-inf for a float max, the integer
extremes for an integer min or max); the lines are ranked by point count
with a stable descending sort, so equal counts keep scan order as
``lax.top_k`` does. Everything runs on the device of `ranges`. The JAX
package jits the whole extraction (its rounds a ``lax.scan``); here it is
one `utils.graphs.Stage`: on the card one graph a scan length and config,
captured once and replayed for every scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import segment_sum as ss
from ..utils import graphs


@dataclass(frozen=True)
class LineExtractorConfig:
    """Defaults follow ``Line2DExtractor`` constructor + clusterer."""

    cluster_squared_distance: float = 0.09  # clusterer break threshold (0.3m)^2
    split_threshold: float = 0.03**2  # squared chord distance
    min_points_in_line: int = 6
    split_rounds: int = 10
    merge_rounds: int = 3
    normal_merge_threshold: float = 0.05  # 1 - |n1.n2|
    rho_merge_threshold: float = 0.07
    max_lines: int = 64
    max_range: float = 30.0


class LineSet(NamedTuple):
    """Fixed-capacity extracted lines.

    p0, p1: (L, 2) endpoints; normal: (L, 2) unit; rho: (L,) with n.p = rho;
    n_points: (L,); mask: (L,) bool.
    """

    p0: torch.Tensor
    p1: torch.Tensor
    normal: torch.Tensor
    rho: torch.Tensor
    n_points: torch.Tensor
    mask: torch.Tensor


def scan_to_points(ranges, angles, valid_mask=None, max_range=30.0):
    """Polar scan -> (N, 2) cartesian points + validity."""
    pts = torch.stack([ranges * torch.cos(angles), ranges * torch.sin(angles)], -1)
    valid = (ranges > 1e-3) & (ranges < max_range) & torch.isfinite(ranges)
    if valid_mask is not None:
        valid = valid & valid_mask
    return pts, valid


def _segment_reduce(values, seg, n_seg, reduce):
    """JAX's ``segment_max`` / ``segment_min``: the identity of the reduction
    (-inf / the integer minimum for max, the integer maximum for min) where a
    segment is empty."""
    if values.dtype.is_floating_point:
        init = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(values.dtype)
        init = info.min if reduce == "amax" else info.max
    out = values.new_full((n_seg,), init)
    return out.scatter_reduce(0, seg, values, reduce=reduce, include_self=True)




def _segment_endpoints(seg_id, pts, valid, n_seg):
    """First/last valid point per segment (by scan order)."""
    n = pts.shape[0]
    order = torch.arange(n, device=pts.device)
    first_idx = _segment_reduce(torch.where(valid, order, n + 1), seg_id, n_seg, "amin")
    last_idx = _segment_reduce(torch.where(valid, order, -1), seg_id, n_seg, "amax")
    first_idx, last_idx = torch.clamp(first_idx, 0, n - 1), torch.clamp(last_idx, 0, n - 1)
    return pts[first_idx], pts[last_idx], first_idx, last_idx


def _chord_distance(p, a, b):
    """Squared distance from p to the chord a-b (degenerate -> dist to a)."""
    d = b - a
    L2 = torch.sum(d * d, -1)
    t = torch.where(L2 > 1e-12, torch.sum((p - a) * d, -1) / torch.clamp_min(L2, 1e-12), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * d
    return torch.sum((p - proj) ** 2, -1)


def _tls_fit(seg_id, pts, valid, n_seg):
    """Per-segment total-least-squares lines via moment accumulation.

    Returns (normal (S,2), rho (S,), count (S,), mean (S,2)). Normal is the
    smaller-eigenvalue direction of the 2x2 scatter (closed form).
    """
    w = valid.to(pts.dtype)
    x, y = pts[:, 0], pts[:, 1]
    # the six moments in one segment sum over an index sorted once
    moments = ss.segment_sum(torch.stack([w, w * x, w * y, w * x * x, w * x * y, w * y * y], 1),
                             ss.SegmentIndex(seg_id, n_seg))
    cnt, sx, sy, sxx, sxy, syy = moments.unbind(1)
    c = torch.clamp_min(cnt, 1.0)
    mx, my = sx / c, sy / c
    cxx = sxx / c - mx * mx
    cxy = sxy / c - mx * my
    cyy = syy / c - my * my
    # smaller eigenvalue of [[cxx, cxy], [cxy, cyy]] and its eigenvector
    tr = cxx + cyy
    det_h = torch.sqrt(torch.clamp_min(((cxx - cyy) * 0.5) ** 2 + cxy * cxy, 0.0))
    lam_small = tr * 0.5 - det_h
    # eigenvector for lam_small: (cxy, lam_small - cxx) or (lam_small - cyy, cxy)
    v1 = torch.stack([cxy, lam_small - cxx], -1)
    v2 = torch.stack([lam_small - cyy, cxy], -1)
    use1 = torch.sum(v1 * v1, -1) > torch.sum(v2 * v2, -1)
    nvec = torch.where(use1[:, None], v1, v2)
    nn = torch.linalg.vector_norm(nvec, dim=-1, keepdim=True)
    # degenerate (isotropic): fall back to the radial direction of the mean
    mean = torch.stack([mx, my], -1)
    fallback = mean / torch.clamp_min(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), 1e-9)
    nvec = torch.where(nn > 1e-9, nvec / torch.clamp_min(nn, 1e-9), fallback)
    rho = torch.sum(nvec * mean, -1)
    # canonical sign: rho >= 0
    flip = rho < 0
    nvec = torch.where(flip[:, None], -nvec, nvec)
    return nvec, torch.abs(rho), cnt, mean


def _segments(brk, n):
    return torch.clamp(torch.cumsum(brk.long(), 0) - 1, 0, n - 1)


def extract_lines(ranges, angles, config: LineExtractorConfig = LineExtractorConfig()) -> LineSet:
    """Extract line segments from one laser scan (fixed-length tensors)."""
    return _EXTRACT_LINES(ranges, angles, config)


def _extract_lines(ranges, angles, config: LineExtractorConfig) -> LineSet:
    """`extract_lines`' eager body."""
    cfg = config
    pts, valid = scan_to_points(ranges, angles, max_range=cfg.max_range)
    n = pts.shape[0]
    order = torch.arange(n, device=pts.device)

    # --- 1. clustering: break where consecutive valid points jump ---
    gap = torch.sum((pts - torch.roll(pts, 1, 0)) ** 2, -1)
    brk = (~torch.roll(valid, 1)) | (gap > cfg.cluster_squared_distance)
    brk = brk | (order == 0)
    brk = brk | (~valid)  # invalid points isolate segments

    # --- 2. split rounds ---
    for _ in range(cfg.split_rounds):
        seg = _segments(brk, n)
        a, bb, _, _ = _segment_endpoints(seg, pts, valid, n)
        d2 = _chord_distance(pts, a[seg], bb[seg])
        d2 = torch.where(valid, d2, -1.0)
        seg_max = _segment_reduce(d2, seg, n, "amax")
        is_max = (d2 >= seg_max[seg]) & (d2 > cfg.split_threshold) & valid
        # break ties: lowest index wins within segment
        first_max = _segment_reduce(torch.where(is_max, order, n + 1), seg, n, "amin")
        has_split = first_max <= n - 1  # per-segment: found a split point
        idx = torch.clamp(first_max, 0, n - 1)
        new_break = torch.zeros(n, dtype=torch.long, device=pts.device).scatter_reduce(
            0, idx, has_split.long(), reduce="amax", include_self=True) > 0
        brk = brk | new_break

    # --- 3. merge rounds (adjacent segments with compatible TLS lines) ---
    prev_ok = torch.roll(valid, 1) & valid
    for _ in range(cfg.merge_rounds):
        sid = _segments(brk, n)
        nvec, rho, cnt, _ = _tls_fit(sid, pts, valid, n)
        # for each breakpoint at position i (i>0): compare segment sid[i]-1, sid[i]
        left = torch.clamp(sid - 1, 0, n - 1)
        ndot = torch.abs(torch.sum(nvec[sid] * nvec[left], -1))
        drho = torch.abs(rho[sid] - rho[left])
        both_ok = (cnt[sid] > 0) & (cnt[left] > 0)
        compatible = (1.0 - ndot < cfg.normal_merge_threshold) & (drho < cfg.rho_merge_threshold) & both_ok
        # a breakpoint may be removed only if the point itself is valid and
        # its predecessor is valid (i.e. not a cluster/validity gap), never
        # the first, and on alternating segment parity so chains do not
        # merge at once
        removable = brk & compatible & prev_ok & (order > 0) & ((sid % 2) == 1)
        brk = brk & ~removable

    # --- 4. emit fixed-capacity line set ---
    seg = _segments(brk, n)
    nvec, rho, cnt, _ = _tls_fit(seg, pts, valid, n)
    a, bpt, _, _ = _segment_endpoints(seg, pts, valid, n)
    good = cnt >= cfg.min_points_in_line

    # rank segments by point count, take top max_lines (ties in scan order)
    score = torch.where(good, cnt, -1.0)
    top = torch.sort(score, descending=True, stable=True).indices[: cfg.max_lines]
    sel_ok = score[top] > 0
    # project endpoints onto the TLS line for clean segment geometry
    tvec = torch.stack([-nvec[:, 1], nvec[:, 0]], -1)  # line direction
    foot = nvec * rho[:, None]

    def proj(p):
        t = torch.sum((p - foot) * tvec, -1)
        return foot + t[:, None] * tvec

    p0, p1 = proj(a)[top], proj(bpt)[top]
    return LineSet(
        p0=torch.where(sel_ok[:, None], p0, 0.0),
        p1=torch.where(sel_ok[:, None], p1, 0.0),
        normal=torch.where(sel_ok[:, None], nvec[top], 0.0),
        rho=torch.where(sel_ok, rho[top], 0.0),
        n_points=torch.where(sel_ok, cnt[top], 0.0),
        mask=sel_ok,
    )


_EXTRACT_LINES = graphs.Stage("extract_lines", _extract_lines)
