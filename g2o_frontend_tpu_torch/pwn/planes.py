"""Plane extraction from organized clouds (counterpart of
``g2o_frontend_tpu/pwn/planes.py``, the PlaneEx equivalent).

The reference extracts planes per RGB-D frame with PCL's sequential
SAC-RANSAC (``PlaneEx/plane_g2o.cpp:216-241``: segment, remove inliers,
repeat). Here the cloud's per-pixel normals (already computed by the
converter) vote:

1. per-pixel plane parameters (n, d = n.p) for pixels with valid normals,
2. Hough voting: (azimuth, elevation, distance) bins filled by one
   scatter-add; the `max_planes` largest bins, each suppressing its
   neighbours in distance, are the hypotheses (a loop on the device: the
   bin of each step stays a tensor, with no host synchronisation),
3. masked refinement of all hypotheses at once: inlier mask by angular +
   distance gates, then a least-squares re-fit through the smallest
   eigenvector of the inliers' 3x3 covariance, `refine_rounds` times,
4. fixed-capacity `PlaneSet` output (normal, d, inlier count, centroid).

Planes use the Hessian form n.p = d with unit n and d >= 0. `torch.argmax`
returns the first of equal maxima, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import math

import torch

from ..ops import segment_sum as ss
from ..ops.eigh3x3 import smallest_eigenvector3x3
from .cloud import Cloud


@dataclass(frozen=True)
class PlaneExtractorConfig:
    n_azimuth_bins: int = 18
    n_elevation_bins: int = 9
    n_distance_bins: int = 20
    max_distance: float = 8.0
    max_planes: int = 8
    angle_threshold: float = 0.1745  # rad (10 deg) inlier gate
    distance_threshold: float = 0.05  # m
    min_inliers: int = 300
    refine_rounds: int = 2


class PlaneSet(NamedTuple):
    normal: torch.Tensor  # (K, 3) unit normals
    d: torch.Tensor  # (K,) offsets, n.p = d
    n_inliers: torch.Tensor  # (K,)
    centroid: torch.Tensor  # (K, 3)
    mask: torch.Tensor  # (K,) bool


def extract_planes(cloud: Cloud, config: PlaneExtractorConfig = PlaneExtractorConfig()) -> PlaneSet:
    cfg = config
    n = cloud.normals.reshape(-1, 3)
    p = cloud.points.reshape(-1, 3)
    dev = p.device
    has_n = (n * n).sum(-1) > 0.5
    d = (n * p).sum(-1)
    # canonicalize: d >= 0 (flip the normal)
    n = torch.where((d < 0)[:, None], -n, n)
    d = d.abs()

    def div(x, c):
        # a tensor divisor: CUDA divides by a Python scalar as a product with
        # its reciprocal, which moves votes across bin edges against the CPU
        return x / torch.full((), c, dtype=x.dtype, device=dev)

    az = torch.arctan2(n[:, 1], n[:, 0])  # [-pi, pi]
    el = torch.arccos(n[:, 2].clamp(-1, 1))  # [0, pi]
    A, E, D = cfg.n_azimuth_bins, cfg.n_elevation_bins, cfg.n_distance_bins
    ia = (div(az + math.pi, 2 * math.pi) * A).to(torch.int32).clamp(0, A - 1)
    ie = (div(el, math.pi) * E).to(torch.int32).clamp(0, E - 1)
    # azimuth is undefined near the +-z poles: collapse the pole rings into
    # one cell so that a fronto-parallel wall does not smear over azimuths
    ia = torch.where((ie == 0) | (ie == E - 1), 0, ia)
    idd = (div(d, cfg.max_distance) * D).to(torch.int32).clamp(0, D - 1)
    B = A * E * D
    bin_idx = torch.where(has_n, (ia * E + ie) * D + idd, B).long()
    # a count: sums of 1.0 are exact in float32 below 2^24 in any order, so
    # the card's atomic adds give the same histogram every run
    hist = torch.zeros(B + 1, device=dev).index_add_(0, bin_idx, torch.ones_like(d))[:-1]
    # per-bin vote means give the hypotheses' parameters (bin centers are
    # too coarse for the refinement gates), summed in a fixed order
    sums = ss.segment_sum(torch.cat([torch.where(has_n[:, None], n, 0.0), torch.where(has_n, d, 0.0)[:, None]], 1),
                          ss.SegmentIndex(bin_idx, B))
    sum_n, sum_d = sums[:, :3], sums[:, 3]

    # the K largest bins; each pick zeroes its normal cell +-1 distance bin
    h = hist.clone()
    sup = torch.arange(D, device=dev)
    bins = []
    for _ in range(cfg.max_planes):
        b = torch.argmax(h)
        cell_bins = (b // D) * D + sup
        h[cell_bins] = torch.where((sup - b % D).abs() <= 1, 0.0, h[cell_bins])
        bins.append(b)
    bins = torch.stack(bins)

    # hypothesis parameters = mean of the bin's votes
    cnt_b = torch.clamp_min(hist[bins], 1.0)
    nh = sum_n[bins] / cnt_b[:, None]
    nh = nh / torch.clamp_min(torch.linalg.vector_norm(nh, dim=-1, keepdim=True), 1e-9)
    dh = sum_d[bins] / cnt_b

    cos_gate = float(torch.cos(torch.tensor(cfg.angle_threshold)))  # float32, as JAX computes it
    for _ in range(cfg.refine_rounds):  # all K hypotheses at once
        ang_ok = n @ nh.T > cos_gate  # (N, K)
        dist_ok = (p @ nh.T - dh).abs() < cfg.distance_threshold
        w = (has_n[:, None] & ang_ok & dist_ok).to(p.dtype).T  # (K, N)
        cnt = w.sum(1)
        c = torch.clamp_min(cnt, 1.0)
        mean = (w @ p) / c[:, None]
        q = p[None] - mean[:, None]  # (K, N, 3)
        cov = torch.einsum("kn,kni,knj->kij", w, q, q) / c[:, None, None]
        _, nn = smallest_eigenvector3x3(cov)
        dd = (nn * mean).sum(-1)
        nn = torch.where((dd < 0)[:, None], -nn, nn)
        dd = dd.abs()
        # keep the previous parameters if degenerate
        ok = cnt >= 3
        nh = torch.where(ok[:, None], nn, nh)
        dh = torch.where(ok, dd, dh)

    ok = cnt >= cfg.min_inliers
    # dedupe: suppress hypothesis j if a higher-count i has the same plane,
    # and ties by index order
    same = (nh @ nh.T > cos_gate) & ((dh[:, None] - dh[None, :]).abs() < 2 * cfg.distance_threshold)
    idx = torch.arange(len(cnt), device=dev)
    dup = same & (cnt[:, None] > cnt[None, :])
    tie = same & (cnt[:, None] == cnt[None, :]) & (idx[:, None] < idx[None, :])
    ok = ok & ~(dup | tie).any(0)
    return PlaneSet(normal=nh, d=dh, n_inliers=cnt, centroid=mean, mask=ok)


def planes_to_array(ps: PlaneSet):
    """(K, 4) [n, d] array + mask, the RANSAC plane-solver input format."""
    return torch.cat([ps.normal, ps.d[:, None]], -1), ps.mask
