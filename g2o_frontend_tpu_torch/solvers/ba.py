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
  each S @ v four `index_add_` passes over the observations;
- landmark update by back-substitution, joint accept or reject on the
  device; the host reads PCG's stopping test once a CG iteration.

The JAX version pins "highest" matmul precision (a reduced-precision
product corrupted the pose products on its chip); importing this package
turns TF32 off for the same reason. The problem is packed at its exact
counts; its tensors set the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..graph.store import _fixed_rows, _tensors
from ..utils import lie
from .pcg import pcg
from .pose_graph import _inv, _jtwj, _pose7_to_T, _segment_sum, _T_to_pose7, _weigh


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


def optimize_ba(ba: BAProblem, iters: int = 10, cg_iters: int = 50, lm_lambda0: float = 1e-4):
    """LM-BA with matrix-free Schur-reduced camera solves; returns (problem,
    chi2 trace (iters+1,))."""
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    dtype, dev = ba.poses.dtype, ba.poses.device
    free_c = (ba.pose_mask & ~ba.fixed).to(dtype)
    free_p = ba.point_mask.to(dtype)
    ci, pi = ba.obs_ij[:, 0], ba.obs_ij[:, 1]
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)

    def chi2_of(poses, points):
        return _linearize(ba._replace(poses=poses, points=points), False)[4]

    poses, points = ba.poses, ba.points
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    trace = [chi2_of(poses, points)]
    for _ in range(iters):
        e, Jc, Jp, w, chi2 = _linearize(ba._replace(poses=poses, points=points))

        we = torch.einsum("kij,kj->ki", w, e)
        g_c = _segment_sum(torch.einsum("kdi,kd->ki", Jc, we), ci, NP)
        g_p = _segment_sum(torch.einsum("kdi,kd->ki", Jp, we), pi, NL)
        D_c = _segment_sum(_jtwj(Jc, w, Jc), ci, NP)
        H_pp = _segment_sum(_jtwj(Jp, w, Jp), pi, NL)
        H_pp_d = H_pp + (lam * H_pp * eye3 + 1e-6 * eye3)
        H_pp_inv = _inv(torch.where(free_p[:, None, None] > 0, H_pp_d, eye3))

        def Hcp_apply(vp, Jc=Jc, Jp=Jp, w=w):  # (NL, 3) -> (NP, 6): sum_obs Jc^T W Jp vp
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jp, vp[pi]))
            return _segment_sum(torch.einsum("kdi,kd->ki", Jc, WJv), ci, NP)

        def Hpc_apply(vc, Jc=Jc, Jp=Jp, w=w):  # (NP, 6) -> (NL, 3)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, vc[ci]))
            return _segment_sum(torch.einsum("kdi,kd->ki", Jp, WJv), pi, NL)

        # Schur right-hand side: b_s = -g_c + H_cp H_pp^-1 g_p
        b_s = (-g_c + Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * free_c[:, None]
        lam_D = lam * D_c * eye6

        def schur_hvp(v, Jc=Jc, w=w, lam_D=lam_D, H_pp_inv=H_pp_inv, Hcp_apply=Hcp_apply, Hpc_apply=Hpc_apply):
            vc = v[0] * free_c[:, None]
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, vc[ci]))
            hcc = _segment_sum(torch.einsum("kdi,kd->ki", Jc, WJv), ci, NP) + torch.einsum("kij,kj->ki", lam_D, vc)
            out = hcc - Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, Hpc_apply(vc)))
            return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

        D_inv = _inv(torch.where(free_c[:, None, None] > 0, D_c + lam_D + 1e-6 * eye6, eye6))

        def precond(r, D_inv=D_inv):
            return (torch.einsum("kij,kj->ki", D_inv, r[0]),)

        (dc,), _, _ = pcg(schur_hvp, (b_s,), precond, max_iters=cg_iters, rtol=1e-8)
        dc = dc * free_c[:, None]
        # back-substitute the points: dp = H_pp^-1 (-g_p - H_pc dc)
        dp = torch.einsum("kij,kj->ki", H_pp_inv, -g_p - Hpc_apply(dc)) * free_p[:, None]

        new_poses = _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dc))
        new_points = points + dp
        new_chi2 = chi2_of(new_poses, new_points)
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return ba._replace(poses=poses, points=points), torch.stack(trace)


def make_ba_problem(poses7, points, observations, fixed_idx=(0,), dtype=torch.float32, device="cuda") -> BAProblem:
    """A BAProblem on `device` at its exact counts. observations: list of
    (pose_idx, point_idx, z (3,), info (3, 3)), or a tuple of arrays (ij (M,
    2), z (M, 3), info (M, 3, 3)) for large problems."""
    n, nl = len(poses7), len(points)
    if isinstance(observations, tuple):
        ij, z, w = (np.asarray(a) for a in observations)
    else:
        ij = np.array([o[:2] for o in observations], np.int64).reshape(-1, 2)
        z = np.array([o[2] for o in observations], np.float64).reshape(-1, 3)
        w = np.array([o[3] for o in observations], np.float64).reshape(-1, 3, 3)
    return _tensors(BAProblem, dict(
        poses=np.asarray(poses7, np.float64).reshape(n, 7), pose_mask=np.ones(n, bool),
        points=np.asarray(points, np.float64).reshape(nl, 3), point_mask=np.ones(nl, bool),
        obs_ij=ij.astype(np.int64), obs_z=z, obs_info=w, obs_mask=np.ones(len(ij), bool),
        fixed=_fixed_rows(n, fixed_idx)), dtype, device)
