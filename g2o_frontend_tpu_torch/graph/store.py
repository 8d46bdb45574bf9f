"""Flat-array SE3 pose graph (counterpart of the `PoseGraph3D` part of
``g2o_frontend_tpu/graph/store.py``).

The map is packed into a struct of tensors with a power-of-two capacity
and validity masks, the layout the JAX solver needs for fixed shapes under
``jit``. PyTorch runs eagerly and needs no fixed shapes, but the port keeps
the same layout so that a graph crosses between the two packages field by
field (`convert.pose_graph3d_from_numpy`). `PoseGraph2D` and the ``.g2o``
log readers wait for the 2D slice.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


def _cap(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n."""
    c = minimum
    while c < n:
        c *= 2
    return c


@dataclass(frozen=True)
class PoseGraph3D:
    """SE3 pose graph; poses stored as [t(3), q_xyzw(4)] like g2o VERTEX_SE3:QUAT."""

    poses: torch.Tensor  # (NP, 7)
    pose_mask: torch.Tensor  # (NP,) bool
    pp_ij: torch.Tensor  # (EP, 2) int64
    pp_meas: torch.Tensor  # (EP, 7)
    pp_info: torch.Tensor  # (EP, 6, 6)
    pp_mask: torch.Tensor  # (EP,) bool
    fixed: torch.Tensor  # (NP,) bool

    @property
    def n_poses(self) -> int:
        return int(self.pose_mask.sum())

    @property
    def n_pp_edges(self) -> int:
        return int(self.pp_mask.sum())

    def with_poses(self, poses) -> "PoseGraph3D":
        return replace(self, poses=poses)
