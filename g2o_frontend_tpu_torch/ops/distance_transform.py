"""Distance maps and Voronoi partitions by the jump-flood algorithm
(counterpart of ``g2o_frontend_tpu/ops/distance_transform.py``).

The reference propagates nearest-obstacle information with queue-based
wavefronts (``voronoi_diagram.h:40-49``, ``distance_map_extractor.cpp``);
here ceil(log2(max(H, W))) + 2 jump-flood rounds of 8-neighbour shifted
min-selects give every cell its nearest seed and squared distance: whole-grid
shifts and compares, no data-dependent control flow.

- `distance_transform`: per-cell nearest seed (row, col) + Euclidean distance;
- `voronoi_edges`: cells whose right or lower neighbour is claimed by a
  different, distant seed (the generalized Voronoi diagram of free space);
- `skeletonize`: ridge cells of the distance field.

Distances are integer sums of squares in float32, exact below 2**24, so the
result is the same on every device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["distance_transform", "voronoi_edges", "skeletonize"]


def distance_transform(occupied, max_rounds: int = 0):
    """Jump-flood nearest-seed transform.

    Args:
      occupied: (H, W) bool tensor, the obstacle (seed) cells.
      max_rounds: jump-flood rounds; 0 -> ceil(log2(max(H, W))) + 2.

    Returns (dist (H, W) float32 Euclidean distance to the nearest seed, inf
    where there is none; nearest (H, W, 2) int32 row/col of that seed, -1
    where there is none).
    """
    H, W = occupied.shape
    if max_rounds == 0:
        max_rounds = int(math.ceil(math.log2(max(H, W)))) + 2
    kw = dict(dtype=torch.int32, device=occupied.device)
    rows = torch.arange(H, **kw)[:, None].expand(H, W)
    cols = torch.arange(W, **kw)[None, :].expand(H, W)
    sr = torch.where(occupied, rows, -1)
    sc = torch.where(occupied, cols, -1)

    def dist2_to(sr, sc):
        d2 = (rows - sr) ** 2 + (cols - sc) ** 2
        return torch.where(sr >= 0, d2.to(torch.float32), float("inf"))

    # the shifts wrap around (torch.roll): every candidate carries its
    # absolute seed coordinates, so a wrapped one is just another seed and
    # the min can only improve
    best_d = dist2_to(sr, sc)
    step0 = 1 << (max_rounds - 1)
    for r in range(max_rounds):
        k = max(step0 >> r, 1)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == 0 and dc == 0:
                    continue
                nsr = torch.roll(sr, (dr * k, dc * k), (0, 1))
                nsc = torch.roll(sc, (dr * k, dc * k), (0, 1))
                nd = dist2_to(nsr, nsc)
                take = nd < best_d
                sr = torch.where(take, nsr, sr)
                sc = torch.where(take, nsc, sc)
                best_d = torch.where(take, nd, best_d)
    return torch.sqrt(best_d), torch.stack([sr, sc], -1)


def voronoi_edges(nearest, min_seed_separation: float = 2.0):
    """Cells whose right or lower neighbour is claimed by a DIFFERENT seed
    more than `min_seed_separation` cells away (that gate drops boundaries
    between adjacent seeds of one obstacle, which the reference merges into
    components, ``voronoi_diagram.cpp``)."""
    sr, sc = nearest[..., 0], nearest[..., 1]
    H, W = sr.shape
    edge = torch.zeros((H, W), dtype=torch.bool, device=sr.device)
    for dim in (0, 1):
        nsr = torch.roll(sr, -1, dim)
        nsc = torch.roll(sc, -1, dim)
        differs = (sr - nsr) ** 2 + (sc - nsc) ** 2 > min_seed_separation**2
        # the wrap-around row / column compares with the far side: masked
        if dim == 0:
            differs[H - 1, :] = False
        else:
            differs[:, W - 1] = False
        edge |= differs
    return edge & (sr >= 0)


def skeletonize(dist, threshold: float = 1.0):
    """Ridge cells of the distance field: at least 6 of the 8 neighbours not
    larger (a neighbour off the grid counts as -1), and distance above
    `threshold` cells."""
    H, W = dist.shape
    cnt = torch.zeros((H, W), dtype=torch.int32, device=dist.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            n = torch.full_like(dist, -1.0)
            n[max(dr, 0):H + min(dr, 0), max(dc, 0):W + min(dc, 0)] = dist[
                max(-dr, 0):H + min(-dr, 0), max(-dc, 0):W + min(-dc, 0)
            ]
            cnt += (n <= dist).to(torch.int32)
    return (cnt >= 6) & (dist > threshold)
