"""Grid maps and correlative scan matching (counterpart of
``g2o_frontend_tpu/laser/scan_matcher.py``).

- `GridSpec`: a dense world-anchored (H, W) grid.
- `build_likelihood_map`: scatter a scan's hits, clamp to 1, blur with a
  separable Gaussian, clamp to 1 (``matching/scan_matcher.h:14-82``).
- `correlative_match`: the exhaustive (x, y, theta) search of
  ``matching/correlative_matcher.h:8-68`` as one FFT cross-correlation a
  rotation, all rotations at once.
- `correlative_match_multires`: the FFT search on a max-pooled grid, then
  exact fine scores in a window around its translation.

Everything runs on the device of the map and stays there: the results are
0-dim and 1-dim tensors, read by the caller where it needs them.

Where the card and the CPU must agree exactly, the arithmetic is fixed:
grid coordinates divide by a 0-dim tensor (CUDA divides by a Python scalar
through its reciprocal), the blur is a fixed sequence of float32 products
and sums (no cuDNN convolution, whose algorithm and TF32 use vary), and
the fine scores sum their float32 terms in float64, which is exact for
them: a fine score is the same number on any device. The FFT scores of
`correlative_match` differ between cuFFT and the CPU's FFT in their last
digits, so where two shifts tie the two may pick different ones.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class GridSpec:
    """Dense world-anchored grid: world = origin + resolution * (col, row)."""

    rows: int
    cols: int
    resolution: float  # meters / cell
    origin_x: float
    origin_y: float

    def world_to_grid(self, pts):
        """(..., 2) world -> continuous (col, row)."""
        res = torch.full((), self.resolution, dtype=pts.dtype, device=pts.device)
        return (pts[..., 0] - self.origin_x) / res, (pts[..., 1] - self.origin_y) / res


class MatchResult(NamedTuple):
    pose: torch.Tensor  # (3,) [x, y, theta] of the scan frame in the map frame
    score: torch.Tensor  # () best correlation score
    scores_theta: torch.Tensor  # (K,) best score per rotation


def _cells(points, valid, spec: GridSpec):
    """(..., N) integer cells of the points, whether each lies inside, and
    its flat index (rows * cols, the dump slot, where not)."""
    u, v = spec.world_to_grid(points)
    ui, vi = torch.round(u).long(), torch.round(v).long()
    inside = valid & (ui >= 0) & (ui < spec.cols) & (vi >= 0) & (vi < spec.rows)
    flat = torch.where(inside, vi * spec.cols + ui, spec.rows * spec.cols)
    return ui, vi, inside, flat


def _hit_images(points, valid, spec: GridSpec):
    """(..., N, 2) points -> (..., H, W) hit counts clamped to 1: one
    scatter-add into H*W + 1 slots per leading index (the last one the dump
    slot of points outside the grid)."""
    _, _, inside, flat = _cells(points, valid, spec)
    lead = flat.shape[:-1]
    n_img = math.prod(lead)
    slots = spec.rows * spec.cols + 1
    offsets = torch.arange(n_img, device=flat.device).reshape(lead + (1,)) * slots
    # hit counts: sums of 1.0 are exact in float32 below 2^24 in any order,
    # so the card's atomic adds give the same image every run
    img = points.new_zeros(n_img * slots).index_add_(0, (flat + offsets).reshape(-1),
                                                       inside.to(points.dtype).reshape(-1))
    img = img.reshape(n_img, slots)[:, :-1].reshape(lead + (spec.rows, spec.cols))
    return torch.clamp_max(img, 1.0)


def _gaussian_taps(sigma_cells: float):
    """The blur's taps as Python floats, computed in float32 on the host as
    the JAX version computes its kernel."""
    radius = max(1, int(3 * sigma_cells))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma_cells) ** 2)
    return (k / torch.max(k)).tolist()


def _blur_axis(img, taps, axis):
    """SAME-padded cross-correlation of the last two axes' `axis` (0: rows,
    1: columns) with the symmetric `taps`, as a fixed sum of shifted
    products."""
    r = len(taps) // 2
    pad = F.pad(img, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    n = img.shape[-2 + axis]
    out = None
    for j, t in enumerate(taps):
        term = (pad[..., j:j + n, :] if axis == 0 else pad[..., :, j:j + n]) * t
        out = term if out is None else out + term
    return out


def build_likelihood_map(points, valid, spec: GridSpec, sigma_cells: float = 1.0):
    """Scatter scan points into the grid and Gaussian-smear: hits clamped to
    1, a separable blur with taps normalized to a peak of 1, clamped to 1.

    points: (N, 2) map-frame points; valid: (N,) bool. Returns (H, W) on
    the points' device.
    """
    taps = _gaussian_taps(sigma_cells)
    m = _blur_axis(_hit_images(points, valid, spec), taps, 0)
    return torch.clamp_max(_blur_axis(m, taps, 1), 1.0)


def _rotate(scan_points, thetas, shift):
    """(N, 2) points rotated by each of (K,) thetas and shifted by (2,):
    (K, N, 2)."""
    c, s = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
    x, y = scan_points[None, :, 0], scan_points[None, :, 1]
    return torch.stack([x * c - y * s + shift[0], x * s + y * c + shift[1]], -1)


def _at(t, i):
    """t[i] for a 0-dim index tensor, on the device: plain indexing with a
    0-dim tensor reads it on the host (``item``), a sync on the card."""
    return t.index_select(0, i.reshape(1))[0]


def _prior(translation_prior, like):
    if translation_prior is None:
        return like.new_zeros(2)
    return torch.as_tensor(translation_prior, dtype=like.dtype, device=like.device)


def correlative_match(likelihood_map, scan_points, scan_valid, spec: GridSpec, thetas,
                      search_radius_cells: int = 32, translation_prior=None) -> MatchResult:
    """Exhaustive (x, y, theta) search via FFT correlation per rotation.

    Args:
      likelihood_map: (H, W) from `build_likelihood_map` (reference scan/map).
      scan_points: (N, 2) current scan in its own frame.
      scan_valid: (N,) bool.
      thetas: (K,) candidate rotations.
      search_radius_cells: max |dx|, |dy| in cells considered valid.
      translation_prior: optional (2,) predicted translation; the shift
        search then covers prior +- radius instead of 0 +- radius.

    Returns MatchResult with the best [x, y, theta]; the first maximum wins
    among equal scores.
    """
    H, W = spec.rows, spec.cols
    prior = _prior(translation_prior, likelihood_map)
    thetas = thetas.to(likelihood_map.dtype)
    Fmap = torch.fft.rfft2(likelihood_map)
    img = _hit_images(_rotate(scan_points, thetas, prior), scan_valid, spec)  # (K, H, W)
    # circular cross-correlation: corr[dy, dx] = sum img[y, x] map[y+dy, x+dx]
    corrs = torch.fft.irfft2(Fmap * torch.conj(torch.fft.rfft2(img)), s=(H, W))
    r = search_radius_cells
    dev = likelihood_map.device
    dy = torch.cat([torch.arange(0, r + 1, device=dev), torch.arange(H - r, H, device=dev)])
    dx = torch.cat([torch.arange(0, r + 1, device=dev), torch.arange(W - r, W, device=dev)])
    sub = corrs[:, dy[:, None], dx[None, :]]  # (K, 2r+1, 2r+1)
    scores_theta = sub.amax(dim=(1, 2))
    k_best = torch.argmax(scores_theta)
    flat = torch.argmax(_at(sub, k_best))
    nx = sub.shape[2]
    oy, ox = _at(dy, flat // nx), _at(dx, flat % nx)
    sy = torch.where(oy > H // 2, oy - H, oy)
    sx = torch.where(ox > W // 2, ox - W, ox)
    # map[y+dy, x+dx] pairing img[y, x]: scan cell (x, y) matches map cell
    # (x+sx, y+sy) -> the scan frame is translated by +s in grid units
    res = torch.full((), spec.resolution, dtype=likelihood_map.dtype, device=dev)
    pose = torch.stack([sx * res + prior[0], sy * res + prior[1], _at(thetas, k_best)])
    return MatchResult(pose, _at(scores_theta, k_best), scores_theta)


def coarse_grid(likelihood_map, spec: GridSpec, coarse_factor: int):
    """The map max-pooled by `coarse_factor` over its [: Hc f, : Wc f] crop,
    and the coarse grid's spec."""
    f = coarse_factor
    Hc, Wc = spec.rows // f, spec.cols // f
    coarse_spec = GridSpec(rows=Hc, cols=Wc, resolution=spec.resolution * f, origin_x=spec.origin_x,
                           origin_y=spec.origin_y)
    pooled = F.max_pool2d(likelihood_map[None, None, : Hc * f, : Wc * f], f, f)[0, 0]
    return pooled, coarse_spec


def fine_scores(likelihood_map, scan_points, scan_valid, spec: GridSpec, thetas, base, w: int):
    """(K, 2w+1, 2w+1) exact scores of the scan rotated by each theta and
    placed at `base` plus every shift of -w..w cells: sum over the scan's
    points of map[cell + shift] / (points in that cell), the FFT
    correlation's semantics, duplicate cells collapsed; a shift that leaves
    the grid scores 0 (it reads a zero border of w cells), a point outside
    the grid weighs 0. One (K, S, S, N) gather; the float32 terms are
    summed in float64, exactly, and returned as float64."""
    H, W = spec.rows, spec.cols
    ui, vi, ins, flat = _cells(_rotate(scan_points, thetas, base), scan_valid, spec)  # (K, N)
    K = ui.shape[0]
    slots = H * W + 1
    offsets = torch.arange(K, device=ui.device)[:, None] * slots
    # hit counts, exact in any order (sums of 1.0 below 2^24)
    hits = likelihood_map.new_zeros(K * slots).index_add_(0, (flat + offsets).reshape(-1),
                                                          ins.to(likelihood_map.dtype).reshape(-1))
    hits = hits.reshape(K, slots).gather(1, flat)
    one = torch.ones((), dtype=likelihood_map.dtype, device=ui.device)
    wgt = torch.where(ins, one / torch.clamp_min(hits, 1.0), 0.0)  # (K, N)
    Wp = W + 2 * w
    padded = F.pad(likelihood_map, (w, w, w, w)).reshape(-1)
    cell = (torch.clamp(vi, 0, H - 1) + w) * Wp + torch.clamp(ui, 0, W - 1) + w  # (K, N); weight 0 where not inside
    shifts = torch.arange(-w, w + 1, device=ui.device)
    step = (shifts[:, None] * Wp + shifts[None, :]).reshape(-1)  # (S * S,) dv-major
    terms = padded[cell[:, None, :] + step[None, :, None]] * wgt[:, None, :]  # (K, S * S, N)
    return terms.sum(-1, dtype=torch.float64).reshape(K, 2 * w + 1, 2 * w + 1)


def correlative_match_multires(likelihood_map, scan_points, scan_valid, spec: GridSpec, thetas,
                               search_radius_cells: int = 32, translation_prior=None,
                               coarse_factor: int = 4) -> MatchResult:
    """Coarse-to-fine correlative search (the reference's multi-level
    ``CorrelativeMatcher`` idea, ``matching/correlative_matcher.h:8-68``).

    Level 1: the FFT sweep of `correlative_match` on a max-pooled grid at
    `coarse_factor` x the resolution; max-pooling makes the coarse score an
    upper bound of the fine one. Level 2: exact fine scores (`fine_scores`)
    in a window of half-width 2f+1 cells around the coarse translation, for
    every rotation. Returns the same MatchResult; the first maximum wins.
    """
    f = coarse_factor
    prior = _prior(translation_prior, likelihood_map)
    thetas = thetas.to(likelihood_map.dtype)
    coarse_map, coarse_spec = coarse_grid(likelihood_map, spec, f)
    coarse = correlative_match(coarse_map, scan_points, scan_valid, coarse_spec, thetas,
                               search_radius_cells=max(1, -(-search_radius_cells // f)), translation_prior=prior)
    # half-width 2f+1: the max-pool peak localizes to one coarse cell, but
    # the true fine peak can sit in a neighbouring coarse cell when the
    # pooled maxima tie: cover a full coarse cell on each side
    w = 2 * f + 1
    base = coarse.pose[:2]
    scores = fine_scores(likelihood_map, scan_points, scan_valid, spec, thetas, base, w)
    scores_theta = scores.amax(dim=(1, 2))
    k_best = torch.argmax(scores_theta)
    flat = torch.argmax(_at(scores, k_best))
    n = 2 * w + 1
    iy, ix = flat // n, flat % n
    res = torch.full((), spec.resolution, dtype=likelihood_map.dtype, device=likelihood_map.device)
    pose = torch.stack([base[0] + (ix - w) * res, base[1] + (iy - w) * res, _at(thetas, k_best)])
    scores_theta = scores_theta.to(likelihood_map.dtype)
    return MatchResult(pose, _at(scores_theta, k_best), scores_theta)
