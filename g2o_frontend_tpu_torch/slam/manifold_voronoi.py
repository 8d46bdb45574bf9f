"""Manifold Voronoi extraction: top-down traversability grids from keyframe
clouds, feeding the Voronoi diagram machinery (counterpart of
``g2o_frontend_tpu/slam/manifold_voronoi.py``).

Re-design of ``pwn_tracker2/manifold_voronoi_extractor.{h,cpp}``: the
reference walks the last ``dequeSize`` cached keyframe clouds point by
point, projecting each into a 2D grid around the current key node and
keeping per cell the deepest point (height code ``pz = 10000 - 1000*z``,
``manifold_voronoi_extractor.cpp:100``), marking cells whose winning point
has a wall-like normal (``n.z() < normalThreshold``) as obstacles
(``:110-120``). Here the per-point loop is one scatter-min of a packed key:
the quantized height in the high bits, the floor/wall class of that very
point in the low bit, so the winner of a cell and its class come out of one
deterministic integer ``amin``. The diagram is the jump-flood distance
transform + Voronoi boundary of ``ops/distance_transform.py``.

Grid coordinates truncate toward zero (``.to(torch.int32)``, as JAX's
``astype``): a point at -0.5 cells lands in cell 0, not -1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import sym6
from ..ops.distance_transform import distance_transform, skeletonize, voronoi_edges
from ..utils import lie

# reference constants (manifold_voronoi_extractor.cpp:40-46,74-78,100)
_FREE_INIT = 30000
_Z_SCALE = 1000.0
_Z_OFFSET = 10000.0


@dataclass(frozen=True)
class ManifoldVoronoiConfig:
    """Defaults = reference constructor (``manifold_voronoi_extractor.cpp:37-46``)."""

    resolution: float = 0.2
    x_size: int = 100
    y_size: int = 100
    normal_threshold: float = 0.64
    deque_size: int = 30


class ManifoldVoronoiData(NamedTuple):
    """The reference's ``ManifoldVoronoiData`` (grid + resolution + node)."""

    height: torch.Tensor  # (x_size, y_size) int32 pz code; _FREE_INIT = empty
    obstacle: torch.Tensor  # (x_size, y_size) bool
    resolution: float
    node_id: int = -1


def manifold_grid(points, normals, valid, x_size: int = 100, y_size: int = 100, resolution: float = 0.2,
                  normal_threshold: float = 0.64):
    """Scatter K clouds into the reference's top-down height/obstacle grid.

    `points`, `normals`: (K, 3, H, W) channel-planar, already in the key
    node's frame (the reference maps each cached cloud by
    ``keyNode^-1 @ cloudNode``, ``manifold_voronoi_extractor.cpp:80-90``);
    `valid`: (K, H, W) bool. Returns (height int32 grid, obstacle bool
    grid); empty cells hold ``_FREE_INIT``.
    """
    cx, cy = x_size * 0.5, y_size * 0.5
    ires = 1.0 / resolution
    px = points[:, 0].reshape(-1)
    py = points[:, 1].reshape(-1)
    pz = points[:, 2].reshape(-1)
    nz = normals[:, 2].reshape(-1)
    nsq = (normals**2).sum(1).reshape(-1)
    ok = valid.reshape(-1) & (nsq >= 0.1)  # normal gate (cpp:109-112)

    gx = (cx + px * ires).to(torch.int32)
    gy = (cy + py * ires).to(torch.int32)
    inside = (gx >= 0) & (gx < x_size) & (gy >= 0) & (gy < y_size) & ok
    zq = torch.clamp((_Z_OFFSET - _Z_SCALE * pz).to(torch.int32), 0, _FREE_INIT - 1)
    is_floor = (nz >= normal_threshold).to(torch.int32)
    # packed key: winner = min pz; the low bit carries the winner's class
    # (floor = 1, so that among equal heights the obstacle wins the min)
    empty = _FREE_INIT * 2 + 1
    key = torch.where(inside, zq * 2 + is_floor, empty)
    cell = torch.where(inside, gx.long() * y_size + gy.long(), 0)
    flat = torch.full((x_size * y_size,), empty, dtype=torch.int32, device=points.device)
    grid = flat.scatter_reduce(0, cell, key, reduce="amin").reshape(x_size, y_size)
    height = grid // 2
    obstacle = (grid % 2 == 0) & (height < _FREE_INIT)
    return height, obstacle


def manifold_diagram(obstacle, squared_resolution: int = 4):
    """(distance map, Voronoi boundary, skeleton) of the free space: the
    reference's ``ManifoldVoronoi`` distance map and diagram
    (``diagram2graph``) as jump-flood nearest-obstacle assignments, the
    diagram being the cells where they change between distant seeds."""
    dist, nearest = distance_transform(obstacle)
    edges = voronoi_edges(nearest, min_seed_separation=float(squared_resolution))
    return dist, edges, skeletonize(dist)


class ManifoldVoronoiExtractor:
    """Host-side counterpart of the reference StreamProcessor: keeps the
    last ``deque_size`` keyframe clouds and, for a key node, emits the
    `ManifoldVoronoiData` of the grid around it."""

    def __init__(self, config: ManifoldVoronoiConfig = ManifoldVoronoiConfig()):
        self.config = config
        self._entries: list[tuple[int, object, torch.Tensor]] = []  # (id, cloud, T)

    def add_keyframe(self, node_id: int, cloud, transform):
        """Cache a keyframe cloud with its 4x4 world pose."""
        T = torch.as_tensor(transform, dtype=torch.float32, device=cloud.p.device)
        self._entries.append((node_id, cloud, T))
        if len(self._entries) > self.config.deque_size:
            self._entries.pop(0)

    def extract(self, key_node_id: int | None = None) -> ManifoldVoronoiData:
        if not self._entries:
            raise ValueError("no keyframes cached")
        if key_node_id is None:
            key_node_id = self._entries[-1][0]
        T_key = next(T for i, _, T in self._entries if i == key_node_id)
        inT = lie.se3_inverse(T_key)
        cfg = self.config
        pts, nrm = [], []
        for _, cloud, T in self._entries:
            # the points and normals of cloud.transform(rel); the grid reads
            # nothing else of the cloud
            rel = inT @ T
            pts.append(torch.stack(sym6.rot_apply(rel[:3, :3], cloud.p)) + rel[:3, 3, None, None])
            nrm.append(torch.stack(sym6.rot_apply(rel[:3, :3], cloud.n)))
        height, obstacle = manifold_grid(
            torch.stack(pts), torch.stack(nrm), torch.stack([c.valid for _, c, _ in self._entries]),
            x_size=cfg.x_size, y_size=cfg.y_size, resolution=cfg.resolution, normal_threshold=cfg.normal_threshold,
        )
        return ManifoldVoronoiData(height, obstacle, cfg.resolution, key_node_id)
