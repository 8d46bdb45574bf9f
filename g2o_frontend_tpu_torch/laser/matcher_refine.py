"""Hierarchical and gradient scan-match refinement (counterpart of
``g2o_frontend_tpu/laser/matcher_refine.py``, mapper/matcher parity).

- `HierarchicalMatcher` (``hierarchical_matcher.h``): the FFT correlative
  matcher on a max-pooled map, then a continuous polish on the fine grid;
- `GradientMatcher` (``gradient_matcher.h``): gradient ascent of the
  bilinearly interpolated likelihood score, the gradient taken by
  `torch.func.grad_and_value` through the interpolation, a fixed number of
  normalized steps that never read the device from the host.

The JAX package jits `gradient_refine` (its steps a ``fori_loop``, the
step count static). Here it is a `utils.graphs.Stage` over
`_gradient_refine`, captured at a key's second call
(``second_call=True``): its callers pass unpadded scans, so a point count
seen once captures nothing. Padding the scan would change the order of
the mean's sum, and so its bits.
"""
from __future__ import annotations

import torch

from ..utils import graphs
from .scan_matcher import GridSpec, correlative_match


def _bilinear(m, u, v):
    """Sample map m at continuous (u=col, v=row); zero outside. `floor` has
    zero derivative: the gradient flows through the weights."""
    H, W = m.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    ui, vi = u0.long(), v0.long()

    def at(vv, uu):
        ok = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
        return torch.where(ok, m[torch.clamp(vv, 0, H - 1), torch.clamp(uu, 0, W - 1)], 0.0)

    return (at(vi, ui) * (1 - du) * (1 - dv) + at(vi, ui + 1) * du * (1 - dv) + at(vi + 1, ui) * (1 - du) * dv
            + at(vi + 1, ui + 1) * du * dv)


def score_pose(likelihood_map, scan_points, scan_valid, spec: GridSpec, pose):
    """Mean map likelihood of the scan transformed by pose [x, y, th]."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    x, y = scan_points[:, 0], scan_points[:, 1]
    px, py = x * c - y * s + pose[0], x * s + y * c + pose[1]
    res = torch.full((), spec.resolution, dtype=likelihood_map.dtype, device=likelihood_map.device)
    vals = _bilinear(likelihood_map, (px - spec.origin_x) / res, (py - spec.origin_y) / res)
    w = scan_valid.to(vals.dtype)
    return torch.sum(vals * w) / torch.clamp_min(torch.sum(w), 1.0)


def gradient_refine(likelihood_map, scan_points, scan_valid, spec: GridSpec, pose0, steps: int = 50, lr=0.05):
    """Gradient-ascent pose refinement; returns (pose, score).

    Each step moves by lr * scale * g / max(|g * scale|, 1e-9), scale being
    (resolution, resolution, resolution / 4): meters for x and y, radians
    for theta."""
    return _REFINE(likelihood_map, scan_points, scan_valid, spec, pose0.to(likelihood_map.dtype), int(steps),
                   float(lr))


def _gradient_refine(likelihood_map, scan_points, scan_valid, spec: GridSpec, pose, steps, lr):
    grad_and_value = torch.func.grad_and_value(
        lambda p: score_pose(likelihood_map, scan_points, scan_valid, spec, p))
    # made on the device: a tensor built from a host list is a host copy, which a capture refuses
    scale = torch.stack([torch.full((), r, dtype=likelihood_map.dtype, device=likelihood_map.device)
                         for r in (spec.resolution, spec.resolution, 0.25 * spec.resolution)])
    for _ in range(steps):
        g, _ = grad_and_value(pose)
        pose = pose + lr * scale * g / torch.clamp_min(torch.linalg.vector_norm(g * scale), 1e-9)
    return pose, score_pose(likelihood_map, scan_points, scan_valid, spec, pose)


_REFINE = graphs.Stage("gradient_refine", _gradient_refine, second_call=True)


def _pool2(m):
    H2, W2 = m.shape[0] // 2 * 2, m.shape[1] // 2 * 2
    return m[:H2, :W2].reshape(H2 // 2, 2, W2 // 2, 2).amax(dim=(1, 3))


def hierarchical_match(likelihood_map, scan_points, scan_valid, spec: GridSpec, thetas, levels: int = 2,
                       search_radius_cells: int = 48, gradient_steps: int = 40):
    """Coarse-to-fine correlative match + gradient polish: the exhaustive
    search on the map max-pooled `levels` times, then `gradient_refine` on
    the fine map. Returns (pose, score, the coarse MatchResult)."""
    m = likelihood_map
    factor = 1 << levels
    for _ in range(levels):
        m = _pool2(m)
    spec_c = GridSpec(rows=m.shape[0], cols=m.shape[1], resolution=spec.resolution * factor,
                      origin_x=spec.origin_x, origin_y=spec.origin_y)
    res_c = correlative_match(m, scan_points, scan_valid, spec_c, thetas,
                              search_radius_cells=max(4, search_radius_cells // factor))
    pose, score = gradient_refine(likelihood_map, scan_points, scan_valid, spec, res_c.pose, steps=gradient_steps)
    return pose, score, res_c
