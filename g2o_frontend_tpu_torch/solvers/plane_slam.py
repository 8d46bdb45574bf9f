"""SE3 pose graph with plane landmarks, the plane-SLAM backend (counterpart
of ``g2o_frontend_tpu/solvers/plane_slam.py``).

The reference builds g2o graphs with `VertexPlane` landmarks and pose-plane
calibration edges (``PlaneEx/plane_g2o.cpp:216-241,383-391``,
``planeAlignerTest``). Here planes are landmarks of the LM solver:

- plane state: Hessian form [n(3), d] with unit n; the local chart is 3-dof
  (two tangent rotations of n and an offset), so the Gauss-Newton system
  stays full-rank without gauge tricks on the normal length;
- pose-plane edge: the plane observed in the pose frame; for pose X = (R, t)
  and global plane (n, d) the prediction is ``n_local = R^T n``,
  ``d_local = d - n . t``; the residual is the 4-vector difference weighted
  by a 4x4 information;
- pose-pose edges as `pose_graph.optimize_se3`;
- matrix-free block-Jacobi PCG (6-blocks for poses, 3-blocks for planes),
  the line graph's LM loop (`line_slam.lm_with_landmarks`).

Jacobians by `torch.func.jacfwd` of each edge batch with respect to one
shared local increment (as `pose_graph.linearize_se3`). `make_plane_graph`
pads the graph to power-of-two capacities as the JAX version does; its
tensors set the device. The LM loop is the line graph's, run through
`utils.graphs.solve_loop` (accept or reject on the device, CG's stopping
test read once a block of `pcg.BLOCK` steps).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.store import _cap, _edge_arrays, _fixed_rows, _pad, _padded_edges, _tensors
from ..utils import lie
from .line_slam import lm_with_landmarks
from .pose_graph import Linearization, _pose7_to_T, _T_to_pose7, _weigh, se3_pp_residual_local


class PlaneGraph(NamedTuple):
    """SE3 + plane-landmark graph."""

    poses: torch.Tensor  # (NP, 7) [t, qxyzw]
    pose_mask: torch.Tensor  # (NP,) bool
    planes: torch.Tensor  # (NL, 4) [n, d]
    plane_mask: torch.Tensor  # (NL,) bool
    pp_ij: torch.Tensor  # (EP, 2) int64
    pp_meas: torch.Tensor  # (EP, 7)
    pp_info: torch.Tensor  # (EP, 6, 6)
    pp_mask: torch.Tensor  # (EP,) bool
    pl_ij: torch.Tensor  # (EL, 2) int64 (pose idx, plane idx)
    pl_meas: torch.Tensor  # (EL, 4) local plane [n, d]
    pl_info: torch.Tensor  # (EL, 4, 4)
    pl_mask: torch.Tensor  # (EL,) bool
    fixed: torch.Tensor  # (NP,) bool


def _plane_tangent(n):
    """Two unit tangent vectors orthogonal to each of (..., 3) normals."""
    # the axes made on the device: a host-made row is a copy a CUDA graph cannot capture
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    ez, ex = eye[2].expand_as(n), eye[0].expand_as(n)
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    t1 = torch.linalg.cross(n, ref)
    t1 = t1 / torch.clamp_min(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), 1e-9)
    return t1, torch.linalg.cross(n, t1)


def _apply_plane_update(plane, dp):
    """3-dof chart: rotate n in its tangent plane, shift d. (..., 4), (..., 3)."""
    n, d = plane[..., :3], plane[..., 3:]
    t1, t2 = _plane_tangent(n)
    n_new = n + dp[..., 0:1] * t1 + dp[..., 1:2] * t2
    n_new = n_new / torch.clamp_min(torch.linalg.vector_norm(n_new, dim=-1, keepdim=True), 1e-9)
    return torch.cat([n_new, d + dp[..., 2:3]], -1)


def _pl_residual_local(dpose, dplane, T, plane, meas):
    """Residuals (EL, 4) as a function of local increments (for Jacobians
    at 0)."""
    X = T @ lie.se3_exp(dpose)
    pl = _apply_plane_update(plane, dplane)
    n, d = pl[..., :3], pl[..., 3]
    R, t = X[..., :3, :3], X[..., :3, 3]
    n_l = torch.einsum("kji,kj->ki", R, n)
    d_l = d - torch.sum(n * t, -1)
    return torch.cat([n_l, d_l[..., None]], -1) - meas


def _linearize(g: PlaneGraph, jacobians: bool = True) -> Linearization:
    """Residuals, Jacobians (with `jacobians`) and information of the
    pose-pose and pose-plane edges, and the chi2."""
    Ti, Tj = _pose7_to_T(g.poses[g.pp_ij[:, 0]]), _pose7_to_T(g.poses[g.pp_ij[:, 1]])
    Zinv = lie.se3_inverse(_pose7_to_T(g.pp_meas))
    Tp, pls = _pose7_to_T(g.poses[g.pl_ij[:, 0]]), g.planes[g.pl_ij[:, 1]]
    z6, z3 = g.poses.new_zeros(6), g.poses.new_zeros(3)
    e_pp = se3_pp_residual_local(z6, z6, Ti, Tj, Zinv)
    e_pl = _pl_residual_local(z6, z3, Tp, pls, g.pl_meas)
    w_pp, chi2_pp = _weigh(e_pp, g.pp_info, g.pp_mask, None)
    w_pl, chi2_pl = _weigh(e_pl, g.pl_info, g.pl_mask, None)
    Ji = Jj = Jp = Jl = None
    if jacobians:
        Ji = torch.func.jacfwd(lambda d: se3_pp_residual_local(d, z6, Ti, Tj, Zinv))(z6)
        Jj = torch.func.jacfwd(lambda d: se3_pp_residual_local(z6, d, Ti, Tj, Zinv))(z6)
        Jp = torch.func.jacfwd(lambda d: _pl_residual_local(d, z3, Tp, pls, g.pl_meas))(z6)
        Jl = torch.func.jacfwd(lambda d: _pl_residual_local(z6, d, Tp, pls, g.pl_meas))(z3)
    return Linearization(e_pp, Ji, Jj, w_pp, e_pl, Jp, Jl, w_pl, chi2_pp + chi2_pl)


def _linearize_at(g: PlaneGraph, poses, planes, jacobians):
    return _linearize(g._replace(poses=poses, planes=planes), jacobians)


def _retract(poses, planes, dp, dl):
    return _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dp)), _apply_plane_update(planes, dl)


def optimize_plane_graph(g: PlaneGraph, iters: int = 10, cg_iters: int = 60, lm_lambda0: float = 1e-4):
    """LM over poses + plane landmarks; returns (graph, chi2 trace (iters+1,))."""
    poses, planes, trace = lm_with_landmarks(
        "optimize_plane_graph", g, g.planes, (g.pose_mask & ~g.fixed).to(g.poses.dtype),
        g.plane_mask.to(g.poses.dtype), _linearize_at, _retract, iters, cg_iters, lm_lambda0)
    return g._replace(poses=poses, planes=planes), trace


def make_plane_graph(poses7, planes4, pp_edges, pl_edges, fixed_idx=(0,), dtype=torch.float32,
                     device="cuda") -> PlaneGraph:
    """A PlaneGraph on `device` from host lists, padded as the JAX version
    pads it to power-of-two capacities (identity poses and measurements,
    the plane z = 0, zero information, masked off): poses (N, 7), planes
    (L, 4), edges (i, j, z, info)."""
    n, nl = len(poses7), len(planes4)
    NP, NL, EP, EL = _cap(max(n, 1)), _cap(max(nl, 1)), _cap(max(len(pp_edges), 1)), _cap(max(len(pl_edges), 1))
    identity, plane0 = np.eye(1, 7, 6)[0], np.eye(1, 4, 2)[0]  # [0 0 0 0 0 0 1], [0 0 1 0]
    return _tensors(PlaneGraph, dict(
        poses=_pad(np.asarray(poses7, np.float64).reshape(n, 7), NP, identity), pose_mask=np.arange(NP) < n,
        planes=_pad(np.asarray(planes4, np.float64).reshape(nl, 4), NL, plane0), plane_mask=np.arange(NL) < nl,
        **_padded_edges("pp", _edge_arrays(pp_edges, 7, 6), EP, identity),
        **_padded_edges("pl", _edge_arrays(pl_edges, 4), EL, plane0),
        fixed=_pad(_fixed_rows(n, fixed_idx), NP)), dtype, device)
