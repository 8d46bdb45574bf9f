"""SE2 pose graph with 2D line landmarks (counterpart of
``g2o_frontend_tpu/solvers/line_slam.py``; line_alignment /
g2o_line_addons).

The reference's line SLAM builds SE2 graphs with `VertexLine2D` landmarks
(angle, rho) plus extreme points (``line_alignment/line_alignment.cpp:
122-650``, ``g2o_line_addons/vertex_extreme_point_xy.h:38``). Here lines are
landmarks of the LM solver:

- line state: (alpha, rho), the world normal angle and offset,
  ``n(alpha) . p = rho``;
- pose-line edge: the line observed in the robot frame; the prediction for
  pose (t, th) is ``alpha_l = alpha - th``, ``rho_l = rho - n(alpha) . t``;
  the residual wraps the angle;
- matrix-free block-Jacobi PCG (3-blocks for poses, 2-blocks for lines),
  the LM loop `lm_with_landmarks` that the plane graph shares, built from
  `pose_graph`'s pose-landmark products.

Jacobians by `torch.func.jacfwd` of each edge batch with respect to one
shared increment, as `pose_graph.linearize_se3` does: every edge's
residual depends on its own ends only. The graph is packed at its exact
counts (the JAX version pads to powers of two: compare prefixes); its
tensors set the device. Accept or reject stays on the device; the host
reads PCG's stopping test once a CG iteration.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..graph.store import _edge_arrays, _fixed_rows, _tensors
from ..utils import lie
from .pcg import pcg
from .pose_graph import (Linearization, _block_jacobi_precond, _compose_hvp, _diag_blocks_se2, _grad_se2,
                         _hvp_edges_se2, _weigh, edge_segments, se2_pp_residual)


class LineGraph(NamedTuple):
    poses: torch.Tensor  # (NP, 3)
    pose_mask: torch.Tensor  # (NP,) bool
    lines: torch.Tensor  # (NL, 2) [alpha, rho]
    line_mask: torch.Tensor  # (NL,) bool
    pp_ij: torch.Tensor  # (EP, 2) int64
    pp_meas: torch.Tensor  # (EP, 3)
    pp_info: torch.Tensor  # (EP, 3, 3)
    pp_mask: torch.Tensor  # (EP,) bool
    pl_ij: torch.Tensor  # (EL, 2) int64 (pose, line)
    pl_meas: torch.Tensor  # (EL, 2) local [alpha, rho]
    pl_info: torch.Tensor  # (EL, 2, 2)
    pl_mask: torch.Tensor  # (EL,) bool
    fixed: torch.Tensor  # (NP,) bool


def line_graph_from_log(log, dtype=torch.float32, device="cuda"):
    """Build a `LineGraph` on `device` from a parsed .g2o with VERTEX_LINE2D /
    EDGE_SE2_LINE2D records (the `line_alignment` output graphs, e.g.
    `datasets/2D/martina/*`). Returns (graph, pose_ids, line_ids)."""
    pose_ids = np.asarray(log.se2_ids, np.int64)
    line_ids = np.asarray(log.line2d_ids, np.int64)
    pid = {int(v): k for k, v in enumerate(pose_ids)}
    lid = {int(v): k for k, v in enumerate(line_ids)}

    pp_ij = np.array([[pid[int(i)], pid[int(j)]] for i, j in log.edge_se2_ij if int(i) in pid and int(j) in pid],
                     np.int64).reshape(-1, 2)
    pp_meas = np.asarray(log.edge_se2_meas, np.float64).reshape(-1, 3)
    pp_info = np.asarray(log.edge_se2_info, np.float64).reshape(-1, 3, 3)

    keep = [k for k, (i, j) in enumerate(log.edge_se2line_ij) if int(i) in pid and int(j) in lid]
    pl_ij = np.array([[pid[int(log.edge_se2line_ij[k][0])], lid[int(log.edge_se2line_ij[k][1])]] for k in keep],
                     np.int64).reshape(-1, 2)
    pl_meas = np.asarray(log.edge_se2line_meas, np.float64)[keep].reshape(-1, 2)
    pl_info = np.asarray(log.edge_se2line_info, np.float64)[keep].reshape(-1, 2, 2)

    fixed = np.zeros(len(pose_ids), bool)
    for v in log.fixed_ids:
        if int(v) in pid:
            fixed[pid[int(v)]] = True
    if not fixed.any() and len(fixed):
        fixed[0] = True

    g = _tensors(LineGraph, dict(
        poses=log.se2_poses, pose_mask=np.ones(len(pose_ids), bool),
        lines=np.asarray(log.line2d_params, np.float64).reshape(-1, 2), line_mask=np.ones(len(line_ids), bool),
        pp_ij=pp_ij, pp_meas=pp_meas, pp_info=pp_info, pp_mask=np.ones(len(pp_ij), bool),
        pl_ij=pl_ij, pl_meas=pl_meas, pl_info=pl_info, pl_mask=np.ones(len(pl_ij), bool),
        fixed=fixed), dtype, device)
    return g, pose_ids, line_ids


def line_observation(pose, line):
    """World lines (..., 2) -> local lines seen from poses (..., 3) [x, y, th]."""
    alpha, rho = line[..., 0], line[..., 1]
    a_l = alpha - pose[..., 2]
    r_l = rho - torch.cos(alpha) * pose[..., 0] - torch.sin(alpha) * pose[..., 1]
    return torch.stack([a_l, r_l], -1)


def _pl_residual(pose, line, meas):
    e = line_observation(pose, line) - meas
    return torch.stack([lie.wrap_angle(e[..., 0]), e[..., 1]], -1)


def _linearize(g: LineGraph, jacobians: bool = True) -> Linearization:
    """Residuals, Jacobians (with `jacobians`) and information of the
    pose-pose and pose-line edges, and the chi2."""
    xi, xj = g.poses[g.pp_ij[:, 0]], g.poses[g.pp_ij[:, 1]]
    xp, ll = g.poses[g.pl_ij[:, 0]], g.lines[g.pl_ij[:, 1]]
    e_pp = se2_pp_residual(xi, xj, g.pp_meas)
    e_pl = _pl_residual(xp, ll, g.pl_meas)
    w_pp, chi2_pp = _weigh(e_pp, g.pp_info, g.pp_mask, None)
    w_pl, chi2_pl = _weigh(e_pl, g.pl_info, g.pl_mask, None)
    Ji = Jj = Jp = Jl = None
    if jacobians:
        z3, z2 = g.poses.new_zeros(3), g.poses.new_zeros(2)
        Ji = torch.func.jacfwd(lambda d: se2_pp_residual(xi + d, xj, g.pp_meas))(z3)
        Jj = torch.func.jacfwd(lambda d: se2_pp_residual(xi, xj + d, g.pp_meas))(z3)
        Jp = torch.func.jacfwd(lambda d: _pl_residual(xp + d, ll, g.pl_meas))(z3)
        Jl = torch.func.jacfwd(lambda d: _pl_residual(xp, ll + d, g.pl_meas))(z2)
    return Linearization(e_pp, Ji, Jj, w_pp, e_pl, Jp, Jl, w_pl, chi2_pp + chi2_pl)


def lm_with_landmarks(poses, lms, pp_ij, pl_ij, free_p, free_l, linearize, retract, iters, cg_iters, lm_lambda0):
    """The LM loop of a pose graph with landmarks (lines, planes): block-
    Jacobi PCG on the pose and landmark blocks, LM damping on the diagonal
    blocks, accept or reject on the device.

    linearize(poses, lms, jacobians) -> `pose_graph.Linearization`;
    retract(poses, lms, dp, dl) -> the updated (poses, lms). Returns (poses,
    lms, chi2 trace (iters+1,))."""
    layout = SimpleNamespace(poses=poses, landmarks=lms, pp_ij=pp_ij, pl_ij=pl_ij)
    seg = edge_segments(layout)  # the edge ends sorted once, for every sum of the solve
    lam = torch.tensor(lm_lambda0, dtype=poses.dtype, device=poses.device)
    trace = [linearize(poses, lms, False).chi2]
    for _ in range(iters):
        lin = linearize(poses, lms, True)
        gp, gl = _grad_se2(layout, lin, seg)
        Dp, Dl = _diag_blocks_se2(layout, lin, seg)
        hvp = _compose_hvp(_hvp_edges_se2(layout, lin, seg), free_p, free_l, lam, Dp, Dl)
        precond = _block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
        (dp, dl), _, _ = pcg(hvp, (-gp * free_p[:, None], -gl * free_l[:, None]), precond, max_iters=cg_iters,
                             rtol=1e-8)
        new_poses, new_lms = retract(poses, lms, dp * free_p[:, None], dl * free_l[:, None])
        new_chi2 = linearize(new_poses, new_lms, False).chi2
        accept = new_chi2 < lin.chi2
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, lin.chi2))
    return poses, lms, torch.stack(trace)


def _wrap_col(x, col):
    return torch.cat([x[:, :col], lie.wrap_angle(x[:, col:col + 1]), x[:, col + 1:]], 1)


def optimize_line_graph(g: LineGraph, iters: int = 10, cg_iters: int = 60, lm_lambda0: float = 1e-4):
    """LM over poses and line landmarks; returns (graph, chi2 trace (iters+1,))."""

    def linearize(poses, lines, jacobians):
        return _linearize(g._replace(poses=poses, lines=lines), jacobians)

    def retract(poses, lines, dp, dl):
        return _wrap_col(poses + dp, 2), _wrap_col(lines + dl, 0)

    poses, lines, trace = lm_with_landmarks(
        g.poses, g.lines, g.pp_ij, g.pl_ij, (g.pose_mask & ~g.fixed).to(g.poses.dtype), g.line_mask.to(g.poses.dtype),
        linearize, retract, iters, cg_iters, lm_lambda0)
    return g._replace(poses=poses, lines=lines), trace


def make_line_graph(poses, lines, pp_edges, pl_edges, fixed_idx=(0,), dtype=torch.float32,
                    device="cuda") -> LineGraph:
    """A LineGraph on `device` from host lists at their exact counts:
    poses (N, 3), lines (L, 2), edges (i, j, z, info)."""
    n, nl = len(poses), len(lines)
    pp_ij, pp_z, pp_w, pp_m = _edge_arrays(pp_edges, 3)
    pl_ij, pl_z, pl_w, pl_m = _edge_arrays(pl_edges, 2)
    return _tensors(LineGraph, dict(
        poses=np.asarray(poses, np.float64).reshape(n, 3), pose_mask=np.ones(n, bool),
        lines=np.asarray(lines, np.float64).reshape(nl, 2), line_mask=np.ones(nl, bool),
        pp_ij=pp_ij, pp_meas=pp_z, pp_info=pp_w, pp_mask=pp_m,
        pl_ij=pl_ij, pl_meas=pl_z, pl_info=pl_w, pl_mask=pl_m, fixed=_fixed_rows(n, fixed_idx)), dtype, device)
