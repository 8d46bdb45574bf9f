"""Integral images (summed-area tables) for windowed point statistics,
channel-planar (counterpart of the planar functions of
``g2o_frontend_tpu/ops/integral_image.py``).

The table is two float32 cumulative sums (rows, then columns); a window sum
reads four corners. Over a 480x640 image the float32 cumsum of p p^T loses
digits, and PyTorch and XLA sum in different orders, so windowed moments
agree with the reference to a tolerance, not bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def integral_image_planar(x):
    """(C, H, W) -> (C, H+1, W+1) summed-area table (leading zero row/col)."""
    s = torch.cumsum(torch.cumsum(x, 1), 2)
    return F.pad(s, (1, 0, 1, 0))


def window_sums(I, radii):
    """Per-pixel windowed sums with exact radii, by a four-corner gather.

    I: (C, H+1, W+1) integral image; radii: (H, W) int per-pixel half-window.
    Returns (C, H, W) sums over the clipped window [i-r, i+r] x [j-r, j+r].
    Planar twin of the JAX ``window_sums`` (used when ``n_radius_levels=0``).
    """
    H, W = I.shape[1] - 1, I.shape[2] - 1
    r = radii.to(torch.int64)
    rows = torch.arange(H, device=I.device)[:, None]
    cols = torch.arange(W, device=I.device)[None, :]
    r0 = torch.clamp(rows - r, 0, H)
    r1 = torch.clamp(rows + r + 1, 0, H)
    c0 = torch.clamp(cols - r, 0, W)
    c1 = torch.clamp(cols + r + 1, 0, W)
    flat = I.reshape(I.shape[0], -1)

    def at(rr, cc):
        return flat[:, (rr * (W + 1) + cc).reshape(-1)].reshape(-1, H, W)

    return at(r1, c1) - at(r0, c1) - at(r1, c0) + at(r0, c0)


def window_sums_fixed_planar(I, r: int):
    """Clamped-window sums for one static radius: four shifted slices of the
    edge-padded table."""
    H, W = I.shape[1] - 1, I.shape[2] - 1
    Ip = F.pad(I[None], (r, r, r, r), mode="replicate")[0]
    s = 2 * r + 1
    c1 = Ip[:, s : s + H, s : s + W]
    c2 = Ip[:, 0:H, s : s + W]
    c3 = Ip[:, s : s + H, 0:W]
    c4 = Ip[:, 0:H, 0:W]
    return c1 - c2 - c3 + c4


def window_sums_quantized_planar(I, radii, levels):
    """Window sums with radii quantized to static `levels`: each pixel takes
    the smallest level >= its radius (the largest level if none)."""
    levels = tuple(sorted(int(l) for l in levels))
    stack = [window_sums_fixed_planar(I, r) for r in levels]
    out = stack[-1]
    for lev, S in zip(levels[-2::-1], stack[-2::-1]):
        out = torch.where((radii <= lev)[None], S, out)
    return out


def window_moments_planar(p, valid, radii, levels=None):
    """Local first/second moments of valid 3D points in a window.

    Args:
      p: (3, H, W) unprojected 3D points.
      valid: (H, W) bool.
      radii: (H, W) int per-pixel half-window.
      levels: static radius levels, or None for exact radii.

    Returns:
      (count (H, W), mean (3, H, W), cov6 (6, H, W)) — cov6 is the sym6
      upper triangle of the sample covariance.
    """
    v = valid.to(p.dtype)
    pm = p * v[None]
    acc = torch.stack(
        [
            v,
            pm[0],
            pm[1],
            pm[2],
            pm[0] * p[0],
            pm[0] * p[1],
            pm[0] * p[2],
            pm[1] * p[1],
            pm[1] * p[2],
            pm[2] * p[2],
        ]
    )
    I = integral_image_planar(acc)
    if levels is not None:
        S = window_sums_quantized_planar(I, radii, levels)
    else:
        S = window_sums(I, radii)
    n = S[0]
    n_safe = torch.clamp_min(n, 1.0)
    mean = S[1:4] / n_safe[None]
    m0, m1, m2 = mean[0], mean[1], mean[2]
    cov6 = torch.stack(
        [
            S[4] / n_safe - m0 * m0,
            S[5] / n_safe - m0 * m1,
            S[6] / n_safe - m0 * m2,
            S[7] / n_safe - m1 * m1,
            S[8] / n_safe - m1 * m2,
            S[9] / n_safe - m2 * m2,
        ]
    )
    return n, mean, cov6
