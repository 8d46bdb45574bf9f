"""Levenberg-Marquardt SE3 pose-graph optimization (counterpart of the SE3
part of ``g2o_frontend_tpu/solvers/pose_graph.py``).

- Per-edge residual ``e = log(Z^-1 (Xi^-1 Xj))`` in the se(3) twist chart,
  with right-multiplicative local updates ``X <- X exp(dx)`` (g2o's
  EdgeSE3 convention).
- Jacobians by forward-mode differentiation (`torch.func.jacfwd`). Every
  edge's residual depends on its own local twists only, so differentiating
  the whole batch of residuals with respect to ONE shared 6-vector gives
  each edge's (6, 6) Jacobian at once: the batched equivalent of the JAX
  version's ``vmap(jacfwd)``.
- Gradient, block diagonal and Hessian-vector products are assembled with
  ``index_add_`` (JAX's ``segment_sum``); the Newton system is solved
  matrix-free by PCG (`pcg.py`) with a block-Jacobi or a chain
  (block-tridiagonal, `tridiag.py`) preconditioner.
- Gauge freedom is handled by projecting the fixed poses' DOFs out.
- LM damping with accept/reject stays on the device (``torch.where``); the
  only host reads are PCG's stopping tests.

The graph's tensors set the device. Float32 matrix products must run in
full float32 (the JAX version pins ``"highest"`` precision for this):
importing the package turns TF32 off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.store import PoseGraph3D
from ..utils import lie
from .pcg import pcg
from .tridiag import cr_factor, cr_solve

PRECONDITIONERS = ("jacobi", "chain")


class Linearization(NamedTuple):
    """Per-edge residuals and Jacobians, plus weights (robust-scaled)."""

    e_pp: torch.Tensor  # (EP, 6)
    Ji_pp: torch.Tensor  # (EP, 6, 6)
    Jj_pp: torch.Tensor  # (EP, 6, 6)
    w_pp: torch.Tensor  # (EP, 6, 6)  information (robust-scaled, masked)
    chi2: torch.Tensor  # () robust chi2, masked


class OptStats(NamedTuple):
    chi2: torch.Tensor  # (iters+1,) robust chi2 trace
    lm_lambda: torch.Tensor  # final lambda
    cg_iters: int  # total CG iterations


def _pose7_to_T(p):
    """(..., 7) [t(3), qx qy qz qw] -> (..., 4, 4)."""
    q = torch.cat([p[..., 6:7], p[..., 3:6]], -1)  # wxyz
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    R = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return lie._hom(R, p[..., :3])


def _T_to_pose7(T):
    q = lie.mat2quat_full(T[..., :3, :3])  # wxyz
    return torch.cat([T[..., :3, 3], q[..., 1:], q[..., :1]], -1)


def se3_pp_residual_local(dxi, dxj, Ti, Tj, Zinv):
    """Residuals (EP, 6) as a function of local twists (for Jacobians at 0)."""
    Xi = Ti @ lie.se3_exp(dxi)
    Xj = Tj @ lie.se3_exp(dxj)
    return lie.se3_log(Zinv @ (lie.se3_inverse(Xi) @ Xj))


def _robust_scale(chi2, huber_delta):
    """Huber weight factor on the information matrix; None disables."""
    if huber_delta is None:
        return torch.ones_like(chi2)
    d2 = huber_delta * huber_delta
    return torch.where(chi2 > d2, torch.sqrt(d2 / torch.clamp_min(chi2, 1e-30)), 1.0)


def linearize_se3(g: PoseGraph3D, huber_delta=None) -> Linearization:
    Ti = _pose7_to_T(g.poses[g.pp_ij[:, 0]])
    Tj = _pose7_to_T(g.poses[g.pp_ij[:, 1]])
    Zinv = lie.se3_inverse(_pose7_to_T(g.pp_meas))
    zero = torch.zeros(6, dtype=g.poses.dtype, device=g.poses.device)
    e = se3_pp_residual_local(zero, zero, Ti, Tj, Zinv)
    Ji = torch.func.jacfwd(lambda d: se3_pp_residual_local(d, zero, Ti, Tj, Zinv))(zero)
    Jj = torch.func.jacfwd(lambda d: se3_pp_residual_local(zero, d, Ti, Tj, Zinv))(zero)
    chi2 = torch.einsum("ki,kij,kj->k", e, g.pp_info, e)
    s = _robust_scale(chi2, huber_delta)
    w = g.pp_info * (s * g.pp_mask)[:, None, None]
    total = torch.where(g.pp_mask, s * chi2, 0.0).sum()
    return Linearization(e, Ji, Jj, w, total)


def _segment_sum(values, index, n):
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, index, values)


def optimize_se3(
    g: PoseGraph3D,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    huber_delta: float | None = None,
    precond: str = "jacobi",
) -> tuple[PoseGraph3D, OptStats]:
    """LM-optimize an SE3 pose graph; updates are right-multiplied twists.

    precond: "jacobi" (the 6x6 block diagonal) or "chain" (the
    block-tridiagonal odometry-chain factor by cyclic reduction).
    """
    if precond not in PRECONDITIONERS:
        raise ValueError(f"precond must be one of {PRECONDITIONERS}, got {precond!r}")
    dtype = g.poses.dtype
    NP = g.poses.shape[0]
    I, J = g.pp_ij[:, 0], g.pp_ij[:, 1]
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=g.poses.device)
    if precond == "chain":
        chain = (J == I + 1) & g.pp_mask
        chain_i = torch.where(chain, I, NP - 1)
        fnext = torch.cat([free_p[1:], free_p.new_zeros(1)])

    trace = [linearize_se3(g, huber_delta).chi2]
    poses = g.poses
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=g.poses.device)
    cg_total = 0
    for _ in range(iters):
        lin = linearize_se3(g.with_poses(poses), huber_delta)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = _segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), I, NP) + _segment_sum(
            torch.einsum("kdi,kd->ki", lin.Jj_pp, we), J, NP
        )
        Hii = torch.einsum("kdi,kde,kej->kij", lin.Ji_pp, lin.w_pp, lin.Ji_pp)
        Hjj = torch.einsum("kdi,kde,kej->kij", lin.Jj_pp, lin.w_pp, lin.Jj_pp)
        Dp = _segment_sum(Hii, I, NP) + _segment_sum(Hjj, J, NP)

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            (vp,) = v
            vp = vp * free_p[:, None]
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = _segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), I, NP) + _segment_sum(
                torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv), J, NP
            )
            hp = hp + lam * torch.einsum("kij,kj->ki", Dp, vp)
            return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * vp,)

        Dp_d = (1.0 + lam) * Dp + 1e-6 * eye6
        Dp_d = torch.where(free_p[:, None, None] > 0, Dp_d, eye6)
        if precond == "chain":
            U_chain = _segment_sum(
                torch.einsum("kdi,kde,kej->kij", lin.Ji_pp, lin.w_pp * chain[:, None, None], lin.Jj_pp), chain_i, NP
            )
            U_pre = U_chain * (free_p * fnext)[:, None, None]
            L_pre = torch.cat([U_pre.new_zeros((1, 6, 6)), U_pre.transpose(1, 2)[:-1]])
            fac = cr_factor(L_pre, Dp_d, U_pre)

            def pre(r, fac=fac):
                return (cr_solve(fac, r[0]),)

        else:
            Dp_inv = torch.linalg.inv_ex(Dp_d, check_errors=False).inverse

            def pre(r, Dp_inv=Dp_inv):
                return (torch.einsum("kij,kj->ki", Dp_inv, r[0]),)

        (dp,), cg_k, _ = pcg(hvp, (-gp * free_p[:, None],), pre, max_iters=cg_iters, rtol=1e-8)
        new_poses = _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dp * free_p[:, None]))
        lin_new = linearize_se3(g.with_poses(new_poses), huber_delta)
        accept = lin_new.chi2 < lin.chi2
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, lin_new.chi2, lin.chi2))
        cg_total += cg_k
    return g.with_poses(poses), OptStats(torch.stack(trace), lam, cg_total)


def chi2_se3(g: PoseGraph3D) -> torch.Tensor:
    return linearize_se3(g).chi2
