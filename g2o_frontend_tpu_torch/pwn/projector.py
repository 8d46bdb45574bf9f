"""Pinhole, multi-camera and cylindrical point projectors (counterpart of
``g2o_frontend_tpu/pwn/projector.py``).

- `unproject`: depth image -> (H, W, 3) points + validity
  (``pinholepointprojector.cpp:69-108``).
- `project`: point set -> depth + pixel index image with a two-pass
  deterministic z-buffer: scatter-min of depth, then the largest point id
  among the depth winners (``scatter_reduce`` with ``amin``, then ``amax``).
- `project_intervals`: per-pixel window radius for a world-space radius.

`MultiProjector` renders a rig of cameras side by side
(``multipointprojector.h:7-14``); `CylindricalProjector` maps columns to
azimuth and rows to elevation-scaled y/r (``cylindricalpointprojector.h:13``).
Both share the pinhole projector's z-buffer.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _zbuffer(projector, points, valid):
    """Two-pass deterministic z-buffer of `projector` (rows, cols, depth
    gates, ``pixel_of``): (depth (H, W), index (H, W) int32)."""
    H, W = projector.rows, projector.cols
    pts = points.reshape(-1, 3)
    ok = valid.reshape(-1)
    u, v, d = projector.pixel_of(pts)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inside = (
        ok
        & (d > projector.min_distance)
        & (d < projector.max_distance)
        & (ui >= 0)
        & (ui < W)
        & (vi >= 0)
        & (vi < H)
    )
    flat_pix = torch.where(inside, vi * W + ui, H * W)  # overflow slot
    big = torch.full((H * W + 1,), float("inf"), dtype=d.dtype, device=d.device)
    dmin = big.scatter_reduce(0, flat_pix, torch.where(inside, d, float("inf")), reduce="amin")
    # winner election: the largest point index whose depth equals the min
    is_winner = inside & (d <= dmin[flat_pix] * (1.0 + 1e-7))
    ids = torch.arange(pts.shape[0], dtype=torch.int32, device=d.device)
    idx = torch.full((H * W + 1,), -1, dtype=torch.int32, device=d.device).scatter_reduce(
        0, flat_pix, torch.where(is_winner, ids, -1), reduce="amax"
    )
    depth_img = torch.where(torch.isfinite(dmin[: H * W]), dmin[: H * W], 0.0)
    return depth_img.reshape(H, W), idx[: H * W].reshape(H, W)


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
        return _zbuffer(self, points, valid)

    def project_intervals(self, depth, world_radius):
        """Per-pixel half-window (pixels) covering world_radius at each depth;
        0 where the depth is invalid."""
        r = torch.where(
            depth > self.min_distance,
            torch.ceil(world_radius * self.fx / torch.clamp_min(depth, 1e-6)),
            0.0,
        )
        return r.to(torch.int32)


def _mount(t, like):
    """A child's 16-float mounting transform as a (4, 4) tensor of `like`'s
    dtype on its device, filled there from scalars: no host copy, so that a
    CUDA graph can capture it (``utils/graphs``)."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype, device=like.device) for v in t]).reshape(4, 4)


@dataclass(frozen=True)
class MultiProjector:
    """Composite projector: sub-projectors stacked along image columns
    (``pwn_core/multipointprojector.h:7-14``). Each child owns a column
    band of the composite image and a rigid mounting transform (child <-
    rig frame). `projectors` is a tuple of (projector, 16-float transform
    tuple) pairs; all children share `rows`."""

    projectors: tuple  # ((PinholeProjector, 16-float transform tuple), ...)

    @property
    def rows(self):
        return self.projectors[0][0].rows

    @property
    def cols(self):
        return sum(p.cols for p, _ in self.projectors)

    def unproject(self, depth):
        """Composite depth -> points in the RIG frame, valid."""
        outs, vals = [], []
        c0 = 0
        for p, t in self.projectors:
            T = _mount(t, depth)
            pts, valid = p.unproject(depth[:, c0 : c0 + p.cols])
            pts = pts @ T[:3, :3].T + T[:3, 3]
            outs.append(torch.where(valid[..., None], pts, 0.0))
            vals.append(valid)
            c0 += p.cols
        return torch.cat(outs, 1), torch.cat(vals, 1)

    def project(self, points, valid):
        """Rig-frame points -> composite (depth, index) image."""
        depths, idxs = [], []
        for p, t in self.projectors:
            T = _mount(t, points)
            Ri = T[:3, :3].T
            local = points @ Ri.T - Ri @ T[:3, 3]
            d, idx = p.project(local, valid)
            depths.append(d)
            idxs.append(idx)
        return torch.cat(depths, 1), torch.cat(idxs, 1)

    def project_intervals(self, depth, world_radius):
        outs = []
        c0 = 0
        for p, _ in self.projectors:
            outs.append(p.project_intervals(depth[:, c0 : c0 + p.cols], world_radius))
            c0 += p.cols
        return torch.cat(outs, 1)


@dataclass(frozen=True)
class CylindricalProjector:
    """Cylindrical projector (``cylindricalpointprojector.h:13``): columns
    map to azimuth, rows to elevation-scaled y/r."""

    rows: int
    cols: int
    angular_fov: float = float(np.pi)  # half-fov in radians
    angular_resolution: float = 0.0  # cols per radian; 0 -> cols/(2*fov)
    vertical_focal: float = 200.0
    vertical_center: float = 0.5  # fraction of rows
    min_distance: float = 0.01
    max_distance: float = 6.0

    def _ares(self):
        return self.angular_resolution or self.cols / (2 * self.angular_fov)

    def pixel_of(self, points):
        """points (..., 3) -> (u, v, r) continuous pixel coords + range."""
        x, y, z = points[..., 0], points[..., 1], points[..., 2]
        theta = torch.arctan2(x, z)
        r = torch.sqrt(x * x + z * z)
        u = theta * self._ares() + self.cols * 0.5
        v = y / torch.clamp_min(r, 1e-9) * self.vertical_focal + self.rows * self.vertical_center
        return u, v, r

    def unproject(self, depth):
        """range image (H, W) -> points (H, W, 3), valid (H, W)."""
        H, W = self.rows, self.cols
        kw = dict(dtype=depth.dtype, device=depth.device)
        vv = torch.arange(H, **kw)[:, None]
        uu = torch.arange(W, **kw)[None, :]
        theta = (uu - W * 0.5) / self._ares()
        r = depth
        x = torch.sin(theta).expand(H, W) * r
        z = torch.cos(theta).expand(H, W) * r
        y = (vv - H * self.vertical_center) / self.vertical_focal * r
        pts = torch.stack([x, y, z], -1)
        valid = (r > self.min_distance) & (r < self.max_distance) & torch.isfinite(r)
        return torch.where(valid[..., None], pts, 0.0), valid

    def project(self, points, valid):
        """Render a point set to (range (H, W), index (H, W) int32)."""
        return _zbuffer(self, points, valid)

    def project_intervals(self, depth, world_radius):
        r = torch.where(
            depth > self.min_distance,
            torch.ceil(world_radius * self._ares() / torch.clamp_min(depth, 1e-6)),
            0.0,
        )
        return r.to(torch.int32)
