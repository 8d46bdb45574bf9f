"""Pinhole point projector (counterpart of ``PinholeProjector`` in
``g2o_frontend_tpu/pwn/projector.py``).

- `unproject`: depth image -> (H, W, 3) points + validity
  (``pinholepointprojector.cpp:69-108``).
- `project`: point set -> depth + pixel index image with a two-pass
  deterministic z-buffer: scatter-min of depth, then the largest point id
  among the depth winners (``scatter_reduce`` with ``amin``, then ``amax``).
- `project_intervals`: per-pixel window radius for a world-space radius.

The Multi and Cylindrical projectors are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PinholeProjector:
    """Intrinsics + depth gates. fx, fy, cx, cy in pixels; distances meters."""

    rows: int
    cols: int
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    min_distance: float = 0.01
    max_distance: float = 6.0

    def scaled(self, s: int) -> "PinholeProjector":
        """Downscale intrinsics by an integer factor s."""
        return PinholeProjector(
            rows=self.rows // s,
            cols=self.cols // s,
            fx=self.fx / s,
            fy=self.fy / s,
            cx=self.cx / s,
            cy=self.cy / s,
            min_distance=self.min_distance,
            max_distance=self.max_distance,
        )

    def unproject(self, depth):
        """depth (H, W) -> points (H, W, 3), valid (H, W)."""
        H, W = self.rows, self.cols
        kw = dict(dtype=depth.dtype, device=depth.device)
        v = torch.arange(H, **kw)[:, None]
        u = torch.arange(W, **kw)[None, :]
        z = depth
        x = (u - self.cx) / self.fx * z
        y = (v - self.cy) / self.fy * z
        pts = torch.stack([x.expand(H, W), y.expand(H, W), z], -1)
        valid = (z > self.min_distance) & (z < self.max_distance) & torch.isfinite(z)
        return torch.where(valid[..., None], pts, 0.0), valid

    def pixel_of(self, points):
        """points (..., 3) -> (u, v, d) continuous pixel coords + depth."""
        d = points[..., 2]
        u = points[..., 0] / d * self.fx + self.cx
        v = points[..., 1] / d * self.fy + self.cy
        return u, v, d

    def project(self, points, valid):
        """Render a point set to (depth (H, W), index (H, W) int32).

        index[i, j] = flat index (into points.reshape(-1, 3)) of the nearest
        point hitting that pixel, or -1.
        """
        H, W = self.rows, self.cols
        pts = points.reshape(-1, 3)
        ok = valid.reshape(-1)
        u, v, d = self.pixel_of(pts)
        ui = torch.round(u).to(torch.int64)
        vi = torch.round(v).to(torch.int64)
        inside = (
            ok
            & (d > self.min_distance)
            & (d < self.max_distance)
            & (ui >= 0)
            & (ui < W)
            & (vi >= 0)
            & (vi < H)
        )
        flat_pix = torch.where(inside, vi * W + ui, H * W)  # overflow slot
        big = torch.full((H * W + 1,), float("inf"), dtype=d.dtype, device=d.device)
        dmin = big.scatter_reduce(
            0, flat_pix, torch.where(inside, d, float("inf")), reduce="amin"
        )
        # winner election: the largest point index whose depth equals the min
        is_winner = inside & (d <= dmin[flat_pix] * (1.0 + 1e-7))
        ids = torch.arange(pts.shape[0], dtype=torch.int32, device=d.device)
        idx = torch.full((H * W + 1,), -1, dtype=torch.int32, device=d.device).scatter_reduce(
            0, flat_pix, torch.where(is_winner, ids, -1), reduce="amax"
        )
        depth_img = torch.where(torch.isfinite(dmin[: H * W]), dmin[: H * W], 0.0)
        return depth_img.reshape(H, W), idx[: H * W].reshape(H, W)

    def project_intervals(self, depth, world_radius):
        """Per-pixel half-window (pixels) covering world_radius at each depth;
        0 where the depth is invalid."""
        r = torch.where(
            depth > self.min_distance,
            torch.ceil(world_radius * self.fx / torch.clamp_min(depth, 1e-6)),
            0.0,
        )
        return r.to(torch.int32)
