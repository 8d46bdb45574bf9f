"""Voxel-grid downsampling of clouds (counterpart of
``g2o_frontend_tpu/pwn/voxel.py``, the VoxelCalculator analog).

Re-design of ``pwn_core/voxelcalculator.{h,cpp}`` (``voxelcalculator.h:
12-60``): points are hashed into a regular voxel grid and each occupied
voxel keeps the centroid of its points. The reference accumulates in an
std::map; here it is one segment sum (`ops.segment_sum`, in point order)
over hashed voxel keys into a fixed-capacity table. The hash is the JAX package's, in int32 with
wrap-around: an int32 tensor times a Python int stays int32 in torch, so the
table is the same bit for bit.
"""
from __future__ import annotations

import torch

from ..ops import segment_sum as ss


def voxelize(points, valid, resolution: float = 0.1, table_size: int = 1 << 16):
    """Centroid-downsample a masked point set.

    Args:
      points: (N, 3); valid: (N,) bool; resolution: voxel edge (m).
      table_size: hash capacity (power of two). Collisions merge distinct
        voxels (acceptable for downsampling; raise table_size to reduce).

    Returns (centroids (table_size, 3), counts (table_size,), occupied mask).
    """
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which moves points across voxel boundaries against
    # the CPU (and JAX)
    key = torch.floor(points / torch.full((), resolution, dtype=points.dtype, device=points.device)).to(torch.int32)
    # 3D -> hash (large primes, power-of-two table)
    h = (key[:, 0] * 73856093 ^ key[:, 1] * 19349663 ^ key[:, 2] * 83492791) & (table_size - 1)
    h = torch.where(valid, h.long(), table_size)
    w = valid.to(points.dtype)
    sums = ss.segment_sum(torch.cat([w[:, None], points * w[:, None]], 1), ss.SegmentIndex(h, table_size))
    cnt, acc = sums[:, 0], sums[:, 1:]
    return acc / torch.clamp_min(cnt, 1.0)[:, None], cnt, cnt > 0


def voxel_downsample(points, valid, resolution: float = 0.1, table_size: int = 1 << 16):
    """Compacted (M, 3) centroids of the occupied voxels, in table order."""
    c, _, occ = voxelize(points.reshape(-1, 3), valid.reshape(-1), resolution, table_size)
    return c[occ]
