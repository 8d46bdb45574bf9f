"""Cloud merging: collapse redundant points after registration (counterpart
of ``g2o_frontend_tpu/pwn/merger.py``).

Re-design of ``pwn_core/merger.cpp:15-110`` (also `pwn_tracker2`'s
`PwnMerger`/`Merger2`): after a new cloud is aligned into a model, points
that re-project onto the same pixel with compatible depth and normal are
fused (weight-averaged) and the duplicates dropped. The model is a
fixed-capacity masked point list and the collapse is scatter arithmetic:

1. z-buffer-project all model points (``PinholeProjector.project``),
2. every point whose pixel winner is a *different* point with
   |dz| < distance_threshold and n.n' > normal_threshold collapses onto the
   winner: weighted positions scatter-add onto winners, losers' masks clear,
3. winners take the fused (weight-averaged) position and accumulated weight.

`add_cloud` writes a registered cloud's valid points into the model's free
slots on the model's device, with no host round trip. The z-buffer winners
(``amin`` / ``amax``) and the masks are deterministic, and so are the fused
positions and weights: one segment sum (`ops.segment_sum`) adds each
winner's losers in their slot order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import segment_sum as ss
from .cloud import Cloud
from .projector import PinholeProjector


@dataclass(frozen=True)
class MergerConfig:
    distance_threshold: float = 0.1  # meters (merger.h default)
    normal_threshold: float = 0.8  # cos angle
    max_point_depth: float = 10.0


class MergedModel(NamedTuple):
    """Flat masked point-with-normal model."""

    points: torch.Tensor  # (C, 3)
    normals: torch.Tensor  # (C, 3)
    weights: torch.Tensor  # (C,) accumulated fusion weight
    mask: torch.Tensor  # (C,) bool

    @property
    def capacity(self):
        return self.points.shape[0]

    def n_points(self):
        return int(self.mask.sum())


def empty_model(capacity: int, dtype=torch.float32, device="cuda") -> MergedModel:
    kw = dict(dtype=dtype, device=device)
    return MergedModel(
        points=torch.zeros((capacity, 3), **kw),
        normals=torch.zeros((capacity, 3), **kw),
        weights=torch.zeros(capacity, **kw),
        mask=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def collapse(model: MergedModel, projector: PinholeProjector, transform=None,
             config: MergerConfig = MergerConfig()) -> MergedModel:
    """One merge pass over the model viewed through `projector` @ `transform`."""
    cfg = config
    pts = model.points
    pts_view = pts @ transform[:3, :3].T + transform[:3, 3] if transform is not None else pts
    depth_img, idx_img = projector.project(pts_view, model.mask)
    u, v, d = projector.pixel_of(pts_view)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    H, W = projector.rows, projector.cols
    inside = (
        model.mask
        & (d > projector.min_distance)
        & (d < cfg.max_point_depth)
        & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    )
    ui = ui.clamp(0, W - 1)
    vi = vi.clamp(0, H - 1)
    winner = idx_img[vi, ui].long()  # flat model index winning this pixel
    wz = depth_img[vi, ui]
    C = model.capacity
    self_idx = torch.arange(C, device=pts.device)
    n_dot = (model.normals * model.normals[winner.clamp_min(0)]).sum(-1)
    collapses = (
        inside
        & (winner >= 0)
        & (winner != self_idx)
        & ((d - wz).abs() < cfg.distance_threshold)
        & (n_dot > cfg.normal_threshold)
    )
    # fuse: scatter the weighted positions of collapsing points onto winners
    w_src = torch.where(collapses, model.weights, 0.0)
    tgt = torch.where(collapses, winner, C)  # overflow slot
    adds = ss.segment_sum(torch.cat([w_src[:, None], w_src[:, None] * model.points], 1), ss.SegmentIndex(tgt, C))
    add_w, add_p = adds[:, 0], adds[:, 1:]
    new_w = model.weights + add_w
    new_p = torch.where(
        (add_w > 0)[:, None],
        (model.weights[:, None] * model.points + add_p) / torch.clamp_min(new_w, 1e-9)[:, None],
        model.points,
    )
    return MergedModel(
        points=new_p,
        normals=model.normals,
        weights=torch.where(collapses, 0.0, new_w),
        mask=model.mask & ~collapses,
    )


def add_cloud(model: MergedModel, cloud: Cloud, transform=None) -> MergedModel:
    """Write a (registered) cloud's valid points, in pixel order, into the
    model's free slots in slot order; points beyond the free capacity are
    dropped. `transform` (4x4) maps the cloud into the model's frame."""
    pts = cloud.points.reshape(-1, 3).to(model.points)
    nrm = cloud.normals.reshape(-1, 3).to(model.points)
    ok = cloud.valid.reshape(-1).to(model.mask.device)
    if transform is not None:
        T = torch.as_tensor(transform, dtype=pts.dtype, device=pts.device)
        pts = pts @ T[:3, :3].T + T[:3, 3]
        nrm = nrm @ T[:3, :3].T
    C = model.capacity
    free = ~model.mask
    # the k-th free slot takes the k-th valid point: slot_of_rank[k] is that
    # slot, or C (a dropped write) past the free slots; occupied slots write
    # their own rank into the spare entry C + 1
    free_rank = torch.cumsum(free, 0) - 1
    slot_of_rank = torch.full((C + 2,), C, dtype=torch.int64, device=free.device)
    slot_of_rank[torch.where(free, free_rank, C + 1)] = torch.arange(C, device=free.device)
    rank = (torch.cumsum(ok, 0) - 1).clamp(0, C)
    target = torch.where(ok, slot_of_rank[rank], C)

    def put(field, values):
        out = torch.cat([field, field[:1]])  # row C takes the dropped writes
        out[target] = values
        return out[:C]

    ones = torch.ones(len(target), dtype=model.weights.dtype, device=target.device)
    return MergedModel(
        points=put(model.points, pts),
        normals=put(model.normals, nrm),
        weights=put(model.weights, ones),
        mask=put(model.mask, torch.ones_like(ok)),
    )
