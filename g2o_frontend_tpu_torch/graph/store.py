"""Flat-array pose graphs (counterpart of ``g2o_frontend_tpu/graph/store.py``).

`PoseGraph2D` holds SE2 poses, XY landmarks, pose-pose and pose-landmark
edges; `PoseGraph3D` holds SE3 poses (x y z qx qy qz qw) and SE3-SE3 edges.
Each is a struct of tensors with validity masks.

The JAX store pads every graph to a power-of-two capacity (`_cap`) so that
XLA sees fixed shapes while a graph grows. PyTorch runs eagerly and needs
no fixed shapes: `graph2d_from_log` and `graph3d_from_log` pack a graph at
its exact counts unless a capacity is asked for. The masks stay, so a
padded JAX graph carried across field by field
(`convert.pose_graph2d_from_numpy`) solves as it is, and a graph with no
landmarks has zero landmark rows where JAX pads to 8.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..io.g2o import G2OLog


def _cap(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity >= n."""
    c = minimum
    while c < n:
        c *= 2
    return c


@dataclass(frozen=True)
class PoseGraph2D:
    """SE2 pose graph with XY landmarks, masked tensors.

    Pose ``i`` is the chart vector [x, y, theta]; landmark ``l`` is [x, y].
    Edge measurements follow g2o conventions: for a pose-pose edge,
    ``z = x_i^{-1} x_j``; for a pose-landmark edge, ``z = R_i^T (l - t_i)``.
    """

    poses: torch.Tensor  # (NP, 3)
    pose_mask: torch.Tensor  # (NP,) bool
    landmarks: torch.Tensor  # (NL, 2)
    landmark_mask: torch.Tensor  # (NL,) bool
    pp_ij: torch.Tensor  # (EP, 2) int64
    pp_meas: torch.Tensor  # (EP, 3)
    pp_info: torch.Tensor  # (EP, 3, 3)
    pp_mask: torch.Tensor  # (EP,) bool
    pl_ij: torch.Tensor  # (EL, 2) int64 (pose, landmark)
    pl_meas: torch.Tensor  # (EL, 2)
    pl_info: torch.Tensor  # (EL, 2, 2)
    pl_mask: torch.Tensor  # (EL,) bool
    fixed: torch.Tensor  # (NP,) bool: the gauge

    @property
    def n_poses(self) -> int:
        return int(self.pose_mask.sum())

    @property
    def n_landmarks(self) -> int:
        return int(self.landmark_mask.sum())

    @property
    def n_pp_edges(self) -> int:
        return int(self.pp_mask.sum())

    @property
    def n_pl_edges(self) -> int:
        return int(self.pl_mask.sum())

    def with_poses(self, poses, landmarks=None) -> "PoseGraph2D":
        new = replace(self, poses=poses)
        if landmarks is not None:
            new = replace(new, landmarks=landmarks)
        return new


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

    def to(self, device) -> "PoseGraph3D":
        """The graph with every tensor on `device` (the float64 host control
        reads CPU tensors)."""
        return PoseGraph3D(*(t.to(device) for t in vars(self).values()))


# -- construction from parsed logs ------------------------------------------------


def _tensors(cls, arrays: dict, dtype, device):
    """{field: numpy array} -> `cls` on `device`: bool and int64 fields keep
    their dtype, the rest become `dtype`."""

    def field(a):
        a = np.asarray(a)
        if a.dtype == bool or a.dtype == np.int64:
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    return cls(**{name: field(a) for name, a in arrays.items()})


def _edge_arrays(edges, dz: int):
    """(i, j, z, info) host tuples -> (ij int64 (E, 2), z (E, dz), info
    (E, dw, dw), mask (E,) all True), dw the information's side."""
    ij = np.array([e[:2] for e in edges], np.int64).reshape(-1, 2)
    z = np.array([e[2] for e in edges], np.float64).reshape(-1, dz)
    w = np.array([e[3] for e in edges], np.float64)
    dw = w.shape[-1] if len(edges) else dz
    return ij, z, w.reshape(-1, dw, dw), np.ones(len(edges), bool)


def _fixed_rows(n: int, fixed_idx) -> np.ndarray:
    """(n,) bool, True at the indices of `fixed_idx` below n."""
    fixed = np.zeros(n, bool)
    fixed[[i for i in fixed_idx if i < n]] = True
    return fixed


def graph2d_from_log(
    log: G2OLog,
    dtype=torch.float32,
    pose_capacity: int | None = None,
    edge_capacity: int | None = None,
    device="cuda",
) -> tuple[PoseGraph2D, dict]:
    """Build a PoseGraph2D on `device` from a parsed .g2o; returns (graph,
    id maps).

    The graph holds exactly the log's poses, landmarks and edges, unless
    `pose_capacity` / `edge_capacity` ask for more pose / pose-pose edge
    rows (masked off). The id maps (`pose_id2idx`, `lm_id2idx`) translate
    g2o vertex ids to rows, for writing results back with the original ids.
    """
    np_, nl = len(log.se2_ids), len(log.xy_ids)
    ep, el = len(log.edge_se2_ij), len(log.edge_se2xy_ij)
    NP = max(pose_capacity or np_, np_)
    EP = max(edge_capacity or ep, ep)

    pose_id2idx = {int(v): i for i, v in enumerate(log.se2_ids)}
    lm_id2idx = {int(v): i for i, v in enumerate(log.xy_ids)}

    poses = np.zeros((NP, 3))
    poses[:np_] = log.se2_poses
    lms = np.asarray(log.xy_points, np.float64).reshape(nl, 2)

    pp_ij = np.zeros((EP, 2), np.int64)
    pp_z = np.zeros((EP, 3))
    pp_w = np.zeros((EP, 3, 3))
    if ep:
        pp_ij[:ep, 0] = [pose_id2idx[int(i)] for i in log.edge_se2_ij[:, 0]]
        pp_ij[:ep, 1] = [pose_id2idx[int(j)] for j in log.edge_se2_ij[:, 1]]
        pp_z[:ep] = log.edge_se2_meas
        pp_w[:ep] = log.edge_se2_info

    pl_ij = np.zeros((el, 2), np.int64)
    if el:
        pl_ij[:, 0] = [pose_id2idx[int(i)] for i in log.edge_se2xy_ij[:, 0]]
        pl_ij[:, 1] = [lm_id2idx[int(j)] for j in log.edge_se2xy_ij[:, 1]]

    fixed = np.zeros(NP, bool)
    for vid in log.fixed_ids:
        if int(vid) in pose_id2idx:
            fixed[pose_id2idx[int(vid)]] = True
    if ep and not fixed.any():
        fixed[0] = True  # default gauge: fix the first pose

    arrays = dict(
        poses=poses,
        pose_mask=np.arange(NP) < np_,
        landmarks=lms,
        landmark_mask=np.ones(nl, bool),
        pp_ij=pp_ij,
        pp_meas=pp_z,
        pp_info=pp_w,
        pp_mask=np.arange(EP) < ep,
        pl_ij=pl_ij,
        pl_meas=np.asarray(log.edge_se2xy_meas, np.float64).reshape(el, 2),
        pl_info=np.asarray(log.edge_se2xy_info, np.float64).reshape(el, 2, 2),
        pl_mask=np.ones(el, bool),
        fixed=fixed,
    )
    return _tensors(PoseGraph2D, arrays, dtype, device), {"pose_id2idx": pose_id2idx, "lm_id2idx": lm_id2idx}


def graph3d_from_log(log: G2OLog, dtype=torch.float32, device="cuda") -> tuple[PoseGraph3D, dict]:
    """Build a PoseGraph3D on `device` from a parsed .g2o, at its exact
    counts; returns (graph, {"pose_id2idx": ...}).

    EDGE_SE3_PRIOR records (the IMU orientation priors of
    ``apps/boss_tools add-imu``) become binary edges from one extra FIXED
    identity anchor pose, appended after the log's poses: the same cost as
    the unary prior, through the solver's one edge type."""
    np_ = len(log.se3_ids)
    ep = len(log.edge_se3_ij)
    npr = len(getattr(log, "prior_se3_ids", ()))
    NP, EP = np_ + (1 if npr else 0), ep + npr
    id2idx = {int(v): i for i, v in enumerate(log.se3_ids)}

    poses = np.zeros((NP, 7))
    poses[:, 6] = 1.0
    poses[:np_] = log.se3_poses
    pp_ij = np.zeros((EP, 2), np.int64)
    pp_z = np.zeros((EP, 7))
    pp_w = np.zeros((EP, 6, 6))
    if ep:
        pp_ij[:ep, 0] = [id2idx[int(i)] for i in log.edge_se3_ij[:, 0]]
        pp_ij[:ep, 1] = [id2idx[int(j)] for j in log.edge_se3_ij[:, 1]]
        pp_z[:ep] = log.edge_se3_meas
        pp_w[:ep] = log.edge_se3_info
    if npr:
        pp_ij[ep:, 0] = np_  # the anchor
        pp_ij[ep:, 1] = [id2idx[int(v)] for v in log.prior_se3_ids]
        pp_z[ep:] = log.prior_se3_meas
        pp_w[ep:] = log.prior_se3_info

    fixed = np.zeros(NP, bool)
    for vid in log.fixed_ids:
        if int(vid) in id2idx:
            fixed[id2idx[int(vid)]] = True
    if npr:
        fixed[np_] = True
    if EP and not fixed.any():
        fixed[0] = True

    arrays = dict(
        poses=poses,
        pose_mask=np.ones(NP, bool),
        pp_ij=pp_ij,
        pp_meas=pp_z,
        pp_info=pp_w,
        pp_mask=np.ones(EP, bool),
        fixed=fixed,
    )
    return _tensors(PoseGraph3D, arrays, dtype, device), {"pose_id2idx": id2idx}
