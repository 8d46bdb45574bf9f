"""Schur-complement and chain-preconditioned LM for SE2 landmark graphs
(counterpart of ``g2o_frontend_tpu/solvers/schur_pcg.py``).

The role of the reference's g2o + CHOLMOD backend on victoriaPark-class
problems: a long odometry chain plus few XY landmarks, loop closures only
through co-observed landmarks. Plain block-Jacobi PCG stalls there: the
chain gives the Hessian an O(N^2) condition number.

1. **Exact Schur elimination of the landmarks.** Hll is block-diagonal
   (2x2 per landmark), so the reduced pose system
   ``S = Hpp - Hpl Hll^-1 Hlp`` is applied matrix-free with batched
   scatter-adds; the landmark increments are recovered exactly afterwards.
2. **A block-tridiagonal chain preconditioner** solved by cyclic reduction
   (`tridiag.py`), either with the full landmark arrow through Woodbury
   (while the dense 2NL x 2NL capacitance stays small) or with a per-pose
   Schur-corrected diagonal.
3. **The gain-ratio (Nielsen) LM schedule** with a convergence exit: the
   loop stops on convergence, and that test is the one host read of an LM
   iteration beside PCG's reads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.store import PoseGraph2D
from ..utils import lie
from . import pose_graph as pg
from .pcg import pcg
from .tridiag import cr_factor, cr_solve

WOODBURY_MAX_DIM = 2048  # the largest 2 NL for which the Woodbury arrow is chosen


class SchurStats(NamedTuple):
    chi2: torch.Tensor  # (iters+1,) trace padded with the final value
    lm_lambda: torch.Tensor
    cg_iters: int  # total CG iterations
    lm_iters: int  # LM iterations run


def _damped_blocks(D, lam, free, d):
    """D + lam diag(D) (the g2o / control convention); identity on fixed and
    padded blocks so that they act as the gauge."""
    eye = torch.eye(d, dtype=D.dtype, device=D.device)
    Dd = D + lam * torch.diag_embed(torch.diagonal(D, dim1=-2, dim2=-1)) + 1e-10 * eye
    return torch.where(free[:, None, None] > 0, Dd, eye)


def _landmark_arrow(C, pose_k, lm_k, free_p, NP, NL):
    """Dense V (NP, 3, 2 NL): the pose-landmark blocks, gauge-projected."""
    Vd = pg._segment_sum(C.reshape(-1, 6), pose_k * NL + lm_k, NP * NL).reshape(NP, NL, 3, 2)
    return Vd.permute(0, 2, 1, 3).reshape(NP, 3, 2 * NL) * free_p[:, None, None]


def _block_diag(blocks):
    """(NL, 2, 2) -> the dense block-diagonal (2 NL, 2 NL)."""
    NL = blocks.shape[0]
    ar = torch.arange(NL, device=blocks.device)
    A = blocks.new_zeros((NL, 2, NL, 2))
    A[ar, :, ar, :] = blocks
    return A.reshape(2 * NL, 2 * NL)


def build_schur_system(gk: PoseGraph2D, lin, lam, consts):
    """(smv, precond, bs, recover_dl) for one damped linearization.

    smv applies the landmark-eliminated damped Schur operator
    ``S_d = Hpp + lam diag(Hpp) - Hpl Hll_d^-1 Hlp`` to pose block-vectors;
    precond applies ``M^-1``, M either T - V A^-1 V^T (the chain
    tridiagonal with the exact landmark arrow, through Woodbury) or the
    Schur-corrected chain tridiagonal; bs is the reduced right-hand side;
    recover_dl back-substitutes the landmark increments.
    """
    NP, NL = consts["NP"], consts["NL"]
    free_p, free_l = consts["free_p"], consts["free_l"]
    has_pl = consts["has_pl"]
    pose_k, lm_k = consts["pose_k"], consts["lm_k"]
    use_woodbury = consts["use_woodbury"]

    gp, gl = pg._grad_se2(gk, lin)
    Dp, Dl = pg._diag_blocks_se2(gk, lin)
    bp = -gp * free_p[:, None]

    if has_pl:
        # per-edge cross block Jp^T W Jl (3x2) and the landmark-block inverse
        C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)
        Hll_inv = pg._inv(_damped_blocks(Dl, lam, free_l, 2))
        ybl = torch.einsum("lij,lj->li", Hll_inv, -gl * free_l[:, None])
        bs = bp - free_p[:, None] * pg._segment_sum(torch.einsum("kij,kj->ki", C, ybl[lm_k]), pose_k, NP)
        # per-pose Schur diagonal correction (exact when each (pose,
        # landmark) pair has one observation edge, as in g2o graphs)
        corr = None if use_woodbury else pg._segment_sum(
            torch.einsum("kij,kjl,kml->kim", C, Hll_inv[lm_k], C), pose_k, NP)
    else:
        bs, corr = bp, torch.zeros_like(Dp)

    edge_hvp = pg._hvp_edges_se2(gk, lin)
    zeros_l = gk.poses.new_zeros((NL, 2))
    diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)

    def smv(v):
        vp = v[0] * free_p[:, None]
        # the pose slot of the edge product with vl = 0 is Hpp v
        hp, _ = edge_hvp((vp, zeros_l))
        hp = hp + lam * diagDp * vp
        if has_pl:
            t = pg._segment_sum(torch.einsum("kji,kj->ki", C, vp[pose_k]), lm_k, NL)
            y = torch.einsum("lij,lj->li", Hll_inv, t)
            hp = hp - pg._segment_sum(torch.einsum("kij,kj->ki", C, y[lm_k]), pose_k, NP)
        return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

    # T: the damped odometry chain, factored by cyclic reduction once per LM
    # iteration
    L_pre, U_pre = pg._chain_blocks(lin, consts["chain"], consts["chain_i"], free_p)
    if use_woodbury:
        # M = T - V A^-1 V^T, the chain with the FULL landmark arrow: exactly S
        # when Hpp has no off-chain blocks. M^-1 = T^-1 + T^-1 V K^-1 V^T T^-1
        # with K = A - V^T T^-1 V (2 NL x 2 NL, dense: landmarks are few)
        fac = cr_factor(L_pre, _damped_blocks(Dp, lam, free_p, 3), U_pre)
        Vd = _landmark_arrow(C, pose_k, lm_k, free_p, NP, NL)
        X = cr_solve(fac, Vd)  # T^-1 V, multi-column cyclic reduction
        # V and X as (3 NP, 2 NL) matrices: their products need no copies
        V2, X2 = Vd.reshape(3 * NP, 2 * NL), X.reshape(3 * NP, 2 * NL)
        K = _block_diag(_damped_blocks(Dl, lam, free_l, 2)) - V2.T @ X2
        K_lu, K_piv, _ = torch.linalg.lu_factor_ex(K)

        def precond(r):
            z = cr_solve(fac, r[0])
            u = torch.linalg.lu_solve(K_lu, K_piv, (z.reshape(1, -1) @ V2).T)
            return (z + (X2 @ u).reshape(NP, 3),)

    else:
        fac = cr_factor(L_pre, _damped_blocks(Dp - corr, lam, free_p, 3), U_pre)

        def precond(r):
            return (cr_solve(fac, r[0]),)

    def recover_dl(dp):
        if not has_pl:
            return zeros_l
        t = pg._segment_sum(torch.einsum("kji,kj->ki", C, dp[pose_k]), lm_k, NL)
        return (ybl - torch.einsum("lij,lj->li", Hll_inv, t)) * free_l[:, None]

    return smv, precond, bs, recover_dl


def landmark_covariance_se2(g: PoseGraph2D, lam: float = 1e-6, huber_delta: float | None = None):
    """Joint landmark covariance blocks through the chain and the Woodbury
    arrow, a (NL, 2, NL, 2) tensor on the graph's device.

    ``cov[l, :, m, :]`` is the (l, m) block of the landmark marginal
    covariance ``(Hll - Hlp T^-1 Hpl)^-1``, T the block-tridiagonal
    (odometry-chain) part of Hpp. Exact when Hpp has no off-chain pose-pose
    blocks; otherwise the off-chain coupling is dropped and the covariances
    are mildly underestimated. Landmarks without observations get an
    identity block (the caller excludes them by their mask).
    """
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    dtype = g.poses.dtype
    if g.pl_ij.shape[0] == 0 or NL == 0:
        return g.poses.new_zeros((NL, 2, NL, 2))
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    chain, chain_i = pg._chain(g)
    lin = pg.linearize_se2(g, huber_delta)
    Dp, Dl = pg._diag_blocks_se2(g, lin)
    C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)
    L_pre, U_pre = pg._chain_blocks(lin, chain, chain_i, free_p)
    fac = cr_factor(L_pre, _damped_blocks(Dp, lam, free_p, 3), U_pre)
    Vd = _landmark_arrow(C, g.pl_ij[:, 0], g.pl_ij[:, 1], free_p, NP, NL)
    X = cr_solve(fac, Vd)
    K = _block_diag(_damped_blocks(Dl, lam, free_l, 2)) - Vd.reshape(3 * NP, 2 * NL).T @ X.reshape(3 * NP, 2 * NL)
    return pg._inv(K).reshape(NL, 2, NL, 2)


def optimize_se2_schur(
    g: PoseGraph2D,
    iters: int = 200,
    cg_iters: int = 250,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
    tol: float = 1e-9,
    cg_rtol: float = 1e-6,
    woodbury: bool | None = None,
) -> tuple[PoseGraph2D, SchurStats]:
    """LM to convergence on the Schur-reduced pose system (see the module
    doc). `woodbury` forces a preconditioner; None chooses the Woodbury
    arrow while 2 NL <= 2048."""
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    has_pl = g.pl_ij.shape[0] > 0
    use_woodbury = (has_pl and 2 * NL <= WOODBURY_MAX_DIM) if woodbury is None else (woodbury and has_pl)
    chain, chain_i = pg._chain(g)
    consts = dict(NP=NP, NL=NL, free_p=free_p, free_l=free_l, has_pl=has_pl,
                  pose_k=g.pl_ij[:, 0] if has_pl else None, lm_k=g.pl_ij[:, 1] if has_pl else None,
                  use_woodbury=use_woodbury, chain=chain, chain_i=chain_i)

    trace = [pg.linearize_se2(g, huber_delta).chi2]
    poses, lms = g.poses, g.landmarks
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=g.poses.device)
    nu = torch.full_like(lam, 2.0)
    k = cg_total = 0
    while k < iters:
        gk = g.with_poses(poses, lms)
        lin = pg.linearize_se2(gk, huber_delta)
        smv, precond, bs, recover_dl = build_schur_system(gk, lin, lam, consts)
        (dp,), cg_k, _ = pcg(smv, (bs,), precond, max_iters=cg_iters, rtol=cg_rtol)
        dp = dp * free_p[:, None]
        dl = recover_dl(dp)
        new_poses = poses + dp
        new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
        new_lms = lms + dl
        lin_new = pg.linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        accept = torch.isfinite(lin_new.chi2) & (lin_new.chi2 < lin.chi2)
        rel_drop = (lin.chi2 - lin_new.chi2) / torch.clamp_min(lin.chi2, 1e-30)
        done = (accept & (rel_drop < tol)) | (~accept & (lam >= 1e10))
        lam, nu = (torch.where(accept, torch.clamp_min(lam / 3.0, 1e-12), torch.clamp_max(lam * nu, 1e10)),
                   torch.where(accept, 2.0, torch.clamp_max(nu * 2.0, 64.0)))
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        trace.append(torch.where(accept, lin_new.chi2, lin.chi2))
        k += 1
        cg_total += cg_k
        if bool(done):
            break
    trace += [trace[-1]] * (iters + 1 - len(trace))
    return g.with_poses(poses, lms), SchurStats(torch.stack(trace), lam, cg_total, k)
