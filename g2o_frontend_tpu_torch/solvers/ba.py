"""Schur-complement bundle adjustment, RGB-D 3D-observation form
(counterpart of ``g2o_frontend_tpu/solvers/ba.py``).

Poses + 3D point landmarks, LM with the reduced camera system, never
materializing a sparse matrix:

- observation: a world point p_w seen from pose X as a local 3D point
  ``z = X^-1 p_w`` with a 3x3 information (the RGB-D / PWN-keyframe
  geometry);
- residual Jacobians by `torch.func.jacfwd` of the whole observation batch
  with respect to one shared local increment (the twist chart for the
  pose, R^3 for the point): the batched ``vmap(jacfwd)``;
- the LM normal system partitioned [camera | point]: the point block H_pp
  is 3x3-block-diagonal and inverted in closed form (`inv_ex`); the Schur
  complement ``S = H_cc - H_cp H_pp^-1 H_pc`` acts matrix-free inside PCG,
  each S @ v four segment sums over the observations (`ops.segment_sum`,
  the camera and point indices sorted once a solve, the padded
  observations sent to the dump slot);
- landmark update by back-substitution, joint accept or reject on the
  device.

The LM loop runs as the JAX version's ``fori_loop`` through
`utils.graphs.solve_loop`: a head (linearize, the point blocks' inverses,
the camera preconditioner, the Schur right-hand side), the camera CG in
blocks of `pcg.BLOCK` masked steps (its stopping test read once a block),
a tail (back-substitution, retraction, accept or reject); on the card each
piece a CUDA graph.

The JAX version pins "highest" matmul precision (a reduced-precision
product corrupted the pose products on its chip); importing this package
turns TF32 off for the same reason. `make_ba_problem` pads the problem to
power-of-two capacities as the JAX version does; its tensors set the
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.store import _cap, _fixed_rows, _pad, _tensors
from ..ops import segment_sum as ss
from ..utils import graphs, lie
from .pcg import cg_carry, cg_loop
from .pose_graph import (LMState, _cg_report, _inv, _jtwj, _pose7_to_T, _start, _T_to_pose7, _weigh, masked_segments,
                         trace_put)


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (NP, 7)
    pose_mask: torch.Tensor  # (NP,) bool
    points: torch.Tensor  # (NL, 3) world points
    point_mask: torch.Tensor  # (NL,) bool
    obs_ij: torch.Tensor  # (M, 2) int64 (pose idx, point idx)
    obs_z: torch.Tensor  # (M, 3) local 3D observation
    obs_info: torch.Tensor  # (M, 3, 3)
    obs_mask: torch.Tensor  # (M,) bool
    fixed: torch.Tensor  # (NP,) bool


def _obs_residual(dpose, dpoint, T, p_w, z):
    X = T @ lie.se3_exp(dpose)
    p = p_w + dpoint
    return torch.einsum("kji,kj->ki", X[..., :3, :3], p - X[..., :3, 3]) - z


def _linearize(ba: BAProblem, jacobians: bool = True):
    """(e, Jc, Jp, w, chi2) of the observations; Jc and Jp None without
    `jacobians`."""
    T = _pose7_to_T(ba.poses[ba.obs_ij[:, 0]])
    P = ba.points[ba.obs_ij[:, 1]]
    z6, z3 = ba.poses.new_zeros(6), ba.poses.new_zeros(3)
    e = _obs_residual(z6, z3, T, P, ba.obs_z)
    w, chi2 = _weigh(e, ba.obs_info, ba.obs_mask, None)
    Jc = Jp = None
    if jacobians:
        Jc = torch.func.jacfwd(lambda d: _obs_residual(d, z3, T, P, ba.obs_z))(z6)
        Jp = torch.func.jacfwd(lambda d: _obs_residual(z6, d, T, P, ba.obs_z))(z3)
    return e, Jc, Jp, w, chi2


class _Consts(NamedTuple):
    free_c: torch.Tensor
    free_p: torch.Tensor
    ci_seg: ss.SegmentIndex
    pi_seg: ss.SegmentIndex


class _Mid(NamedTuple):
    chi2: torch.Tensor
    Jc: torch.Tensor
    Jp: torch.Tensor
    w: torch.Tensor
    g_p: torch.Tensor
    H_pp_inv: torch.Tensor
    lam_D: torch.Tensor
    D_inv: torch.Tensor
    tol2: torch.Tensor | None


def _Hcp_apply(ba, c, m, vp):  # (NL, 3) -> (NP, 6): sum_obs Jc^T W Jp vp
    WJv = torch.einsum("kde,ke->kd", m.w, torch.einsum("kdi,ki->kd", m.Jp, vp[ba.obs_ij[:, 1]]))
    return ss.segment_sum(torch.einsum("kdi,kd->ki", m.Jc, WJv), c.ci_seg)


def _Hpc_apply(ba, c, m, vc):  # (NP, 6) -> (NL, 3)
    WJv = torch.einsum("kde,ke->kd", m.w, torch.einsum("kdi,ki->kd", m.Jc, vc[ba.obs_ij[:, 0]]))
    return ss.segment_sum(torch.einsum("kdi,kd->ki", m.Jp, WJv), c.pi_seg)


def _operators(cs):
    """(the Schur complement's product, the camera block-Jacobi
    preconditioner) of an LM iteration."""
    (ba, c, _), m = cs
    free_c = c.free_c

    def schur_hvp(v):
        vc = v[0] * free_c[:, None]
        WJv = torch.einsum("kde,ke->kd", m.w, torch.einsum("kdi,ki->kd", m.Jc, vc[ba.obs_ij[:, 0]]))
        hcc = ss.segment_sum(torch.einsum("kdi,kd->ki", m.Jc, WJv), c.ci_seg) + torch.einsum("kij,kj->ki", m.lam_D, vc)
        out = hcc - _Hcp_apply(ba, c, m, torch.einsum("kij,kj->ki", m.H_pp_inv, _Hpc_apply(ba, c, m, vc)))
        return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

    def precond(r):
        return (torch.einsum("kij,kj->ki", m.D_inv, r[0]),)

    return schur_hvp, precond


def _head(inputs, st: LMState):
    """Linearize; the gradient, the camera and point blocks, the point
    blocks' inverses, the preconditioner and the Schur right-hand side;
    start CG."""
    ba, c, _ = inputs
    dtype, dev = st.poses.dtype, st.poses.device
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)
    e, Jc, Jp, w, chi2 = _linearize(ba._replace(poses=st.poses, points=st.lms))
    we = torch.einsum("kij,kj->ki", w, e)
    g_c = ss.segment_sum(torch.einsum("kdi,kd->ki", Jc, we), c.ci_seg)
    g_p = ss.segment_sum(torch.einsum("kdi,kd->ki", Jp, we), c.pi_seg)
    D_c = ss.segment_sum(_jtwj(Jc, w, Jc), c.ci_seg)
    H_pp = ss.segment_sum(_jtwj(Jp, w, Jp), c.pi_seg)
    H_pp_d = H_pp + (st.lam * H_pp * eye3 + 1e-6 * eye3)
    H_pp_inv = _inv(torch.where(c.free_p[:, None, None] > 0, H_pp_d, eye3))
    lam_D = st.lam * D_c * eye6
    D_inv = _inv(torch.where(c.free_c[:, None, None] > 0, D_c + lam_D + 1e-6 * eye6, eye6))
    m = _Mid(chi2, Jc, Jp, w, g_p, H_pp_inv, lam_D, D_inv, None)
    # Schur right-hand side: b_s = -g_c + H_cp H_pp^-1 g_p
    b_s = (-g_c + _Hcp_apply(ba, c, m, torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * c.free_c[:, None]
    carry, tol2 = cg_carry((b_s,), _operators((inputs, m))[1], 1e-8)
    return m._replace(tol2=tol2), carry


def _tail(inputs, st: LMState, m: _Mid, carry) -> LMState:
    """Back-substitute the points, retract, accept or reject."""
    ba, c, _ = inputs
    dc = carry.x[0] * c.free_c[:, None]
    # dp = H_pp^-1 (-g_p - H_pc dc)
    dp = torch.einsum("kij,kj->ki", m.H_pp_inv, -m.g_p - _Hpc_apply(ba, c, m, dc)) * c.free_p[:, None]
    new_poses = _T_to_pose7(_pose7_to_T(st.poses) @ lie.se3_exp(dc))
    new_points = st.lms + dp
    new_chi2 = _linearize(ba._replace(poses=new_poses, points=new_points), False)[4]
    accept = new_chi2 < m.chi2
    poses = torch.where(accept, new_poses, st.poses)
    points = torch.where(accept, new_points, st.lms)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = trace_put(st.trace, st.k, torch.where(accept, new_chi2, m.chi2))
    return LMState(poses, points, lam, trace, st.k + 1, st.cg_total + carry.k)


def optimize_ba(ba: BAProblem, iters: int = 10, cg_iters: int = 50, lm_lambda0: float = 1e-4):
    """LM-BA with matrix-free Schur-reduced camera solves; returns (problem,
    chi2 trace (iters+1,))."""
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    dtype = ba.poses.dtype
    consts = _Consts((ba.pose_mask & ~ba.fixed).to(dtype), ba.point_mask.to(dtype),
                     masked_segments(ba.obs_ij[:, 0], ba.obs_mask, NP),
                     masked_segments(ba.obs_ij[:, 1], ba.obs_mask, NL))
    state = _start(ba.poses, _linearize(ba, False)[4], lm_lambda0, iters, ba.points)
    solve = graphs.Solve(_head, _tail, _cg_report, cg_loop(_operators, lambda cs: cs[1].tol2, cg_iters))
    st, _ = graphs.solve_loop("optimize_ba", solve, (ba, consts, cg_iters), state, iters)
    return ba._replace(poses=st.poses, points=st.lms), st.trace


def make_ba_problem(poses7, points, observations, fixed_idx=(0,), dtype=torch.float32, device="cuda") -> BAProblem:
    """A BAProblem on `device`, padded as the JAX version pads it to
    power-of-two capacities (identity poses, zero points, observations of
    point 0 from pose 0 with zero information, masked off). observations:
    list of (pose_idx, point_idx, z (3,), info (3, 3)), or a tuple of
    arrays (ij (M, 2), z (M, 3), info (M, 3, 3)) for large problems."""
    n, nl = len(poses7), len(points)
    if isinstance(observations, tuple):
        ij, z, w = (np.asarray(a) for a in observations)
    else:
        ij = np.array([o[:2] for o in observations], np.int64).reshape(-1, 2)
        z = np.array([o[2] for o in observations], np.float64).reshape(-1, 3)
        w = np.array([o[3] for o in observations], np.float64).reshape(-1, 3, 3)
    m = len(ij)
    NP, NL, M = _cap(max(n, 1)), _cap(max(nl, 1)), _cap(max(m, 1))
    return _tensors(BAProblem, dict(
        poses=_pad(np.asarray(poses7, np.float64).reshape(n, 7), NP, np.eye(1, 7, 6)[0]),
        pose_mask=np.arange(NP) < n,
        points=_pad(np.asarray(points, np.float64).reshape(nl, 3), NL), point_mask=np.arange(NL) < nl,
        obs_ij=_pad(ij.astype(np.int64), M), obs_z=_pad(z, M), obs_info=_pad(w, M), obs_mask=np.arange(M) < m,
        fixed=_pad(_fixed_rows(n, fixed_idx), NP)), dtype, device)
