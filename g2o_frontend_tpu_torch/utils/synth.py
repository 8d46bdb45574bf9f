"""Synthetic plane-scene depth rendering (counterpart of
``g2o_frontend_tpu/utils/synth.py``): analytic ray casting with exact
ground truth, in numpy, returned as a float32 tensor on the asked device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..pwn.projector import PinholeProjector

# A closed "room" of 6 axis-aligned planes (normals point inward), with
# asymmetric wall distances so that no 180-degree yaw fits as well.
ROOM_PLANES = [
    (np.array([0.0, 0.0, -1.0]), -2.5),  # back wall z = 2.5
    (np.array([0.0, 0.0, 1.0]), -2.0),  # front wall z = -2.0
    (np.array([-1.0, 0.0, 0.0]), -1.8),  # right wall x = 1.8
    (np.array([1.0, 0.0, 0.0]), -1.3),  # left wall x = -1.3
    (np.array([0.0, -1.0, 0.0]), -1.0),  # floor y = 1.0
    (np.array([0.0, 1.0, 0.0]), -0.8),  # ceiling y = -0.8
]


def render_planes_depth(T_wc, projector: PinholeProjector, planes=None, device="cpu"):
    """Ray-cast planes (n, d) with n.p = d from camera pose T_wc (4x4 numpy)
    -> (H, W) float32 depth tensor on `device`, 0 where no plane is hit."""
    planes = planes if planes is not None else ROOM_PLANES
    H, W = projector.rows, projector.cols
    vs, us = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack(
        [
            (us - projector.cx) / projector.fx,
            (vs - projector.cy) / projector.fy,
            np.ones_like(us, float),
        ],
        -1,
    )
    T_wc = np.asarray(T_wc, np.float64)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    dirs_w = dirs @ R.T
    depth = np.full((H, W), np.inf)
    for n, d in planes:
        denom = dirs_w @ n
        with np.errstate(divide="ignore"):
            z = np.where(np.abs(denom) > 1e-9, (d - t @ n) / denom, np.inf)
        depth = np.minimum(depth, np.where(z > 0.05, z, np.inf))
    depth[~np.isfinite(depth)] = 0.0
    return torch.as_tensor(depth.astype(np.float32), device=device)


def default_projector(H=120, W=160):
    return PinholeProjector(
        rows=H,
        cols=W,
        fx=131.25 * W / 160,
        fy=131.25 * W / 160,
        cx=W / 2 - 0.5,
        cy=H / 2 - 0.5,
        min_distance=0.1,
        max_distance=10.0,
    )
