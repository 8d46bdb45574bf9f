"""Schur-complement and chain-preconditioned LM for SE2 landmark graphs
(counterpart of ``g2o_frontend_tpu/solvers/schur_pcg.py``).

The role of the reference's g2o + CHOLMOD backend on victoriaPark-class
problems: a long odometry chain plus few XY landmarks, loop closures only
through co-observed landmarks. Plain block-Jacobi PCG stalls there: the
chain gives the Hessian an O(N^2) condition number.

1. **Exact Schur elimination of the landmarks.** Hll is block-diagonal
   (2x2 per landmark), so the reduced pose system
   ``S = Hpp - Hpl Hll^-1 Hlp`` is applied matrix-free with batched
   segment sums (`ops.segment_sum`, their indices sorted once a solve);
   the landmark increments are recovered exactly afterwards.
2. **A block-tridiagonal chain preconditioner** solved by cyclic reduction
   (`tridiag.py`), either with the full landmark arrow through Woodbury
   (while the dense 2NL x 2NL capacitance stays small) or with a per-pose
   Schur-corrected diagonal.
3. **The gain-ratio (Nielsen) LM schedule** with a convergence exit,
   tested on the device. The LM iteration runs as `utils.graphs.solve_loop`
   runs a solve (the JAX version's ``lax.while_loop``): on the card a graph
   for the head, one for each block of CG steps and one for the tail, one
   host read a CG block and one an LM iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.store import PoseGraph2D
from ..ops import segment_sum as ss
from ..utils import graphs, lie
from . import pose_graph as pg
from .pcg import cg_carry, cg_loop
from .tridiag import CRFactor, cr_factor, cr_solve

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


def _arrow_index(pose_k, lm_k, NP, NL):
    """The (pose, landmark) slot of each pose-landmark edge, NP * NL slots."""
    return ss.SegmentIndex(pose_k * NL + lm_k, NP * NL)


def _landmark_arrow(C, arrow, free_p, NP, NL):
    """Dense V (NP, 3, 2 NL): the pose-landmark blocks (summed over
    `_arrow_index`'s slots), gauge-projected."""
    Vd = ss.segment_sum(C.reshape(-1, 6), arrow).reshape(NP, NL, 3, 2)
    return Vd.permute(0, 2, 1, 3).reshape(NP, 3, 2 * NL) * free_p[:, None, None]


def _block_diag(blocks):
    """(NL, 2, 2) -> the dense block-diagonal (2 NL, 2 NL)."""
    NL = blocks.shape[0]
    ar = torch.arange(NL, device=blocks.device)
    A = blocks.new_zeros((NL, 2, NL, 2))
    A[ar, :, ar, :] = blocks
    return A.reshape(2 * NL, 2 * NL)


class SchurConsts(NamedTuple):
    """What a Schur solve fixes once: sizes and choices (static), masks and
    the segment indices of its sums."""

    NP: int
    NL: int
    has_pl: bool
    use_woodbury: bool
    free_p: torch.Tensor
    free_l: torch.Tensor
    pose_k: torch.Tensor | None
    lm_k: torch.Tensor | None
    seg: pg.EdgeSegments
    arrow: ss.SegmentIndex | None
    chain: torch.Tensor
    chain_i: ss.SegmentIndex


class SchurSystem(NamedTuple):
    """One damped linearization's reduced system: the right-hand side, the
    landmark blocks and the preconditioner's factors (None where unused)."""

    bs: torch.Tensor  # (NP, 3) reduced right-hand side
    C: torch.Tensor | None  # (EL, 3, 2) per-edge cross blocks Jp^T W Jl
    Hll_inv: torch.Tensor | None  # (NL, 2, 2) damped landmark-block inverses
    ybl: torch.Tensor | None  # (NL, 2)
    diagDp: torch.Tensor  # (NP, 3)
    zeros_l: torch.Tensor  # (NL, 2)
    fac: CRFactor  # the damped chain tridiagonal (Schur-corrected without Woodbury)
    V2: torch.Tensor | None  # (3 NP, 2 NL) the landmark arrow (Woodbury)
    X2: torch.Tensor | None  # T^-1 V
    K_lu: torch.Tensor | None  # the capacitance K's LU factor and pivots
    K_piv: torch.Tensor | None


def schur_system(gk: PoseGraph2D, lin, lam, consts: SchurConsts) -> SchurSystem:
    """The reduced system of one damped linearization (`schur_operators`
    applies it)."""
    NP, NL = consts.NP, consts.NL
    free_p, free_l, lm_k, seg = consts.free_p, consts.free_l, consts.lm_k, consts.seg

    gp, gl = pg._grad_se2(gk, lin, seg)
    Dp, Dl = pg._diag_blocks_se2(gk, lin, seg)
    bp = -gp * free_p[:, None]

    C = Hll_inv = ybl = None
    if consts.has_pl:
        # per-edge cross block Jp^T W Jl (3x2) and the landmark-block inverse
        C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)
        Hll_inv = pg._inv(_damped_blocks(Dl, lam, free_l, 2))
        ybl = torch.einsum("lij,lj->li", Hll_inv, -gl * free_l[:, None])
        bs = bp - free_p[:, None] * ss.segment_sum(torch.einsum("kij,kj->ki", C, ybl[lm_k]), seg.pl_p)
        # per-pose Schur diagonal correction (exact when each (pose,
        # landmark) pair has one observation edge, as in g2o graphs)
        corr = None if consts.use_woodbury else ss.segment_sum(
            torch.einsum("kij,kjl,kml->kim", C, Hll_inv[lm_k], C), seg.pl_p)
    else:
        bs, corr = bp, torch.zeros_like(Dp)
    zeros_l = gk.poses.new_zeros((NL, 2))
    diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)

    # T: the damped odometry chain, factored by cyclic reduction once per LM
    # iteration
    L_pre, U_pre = pg._chain_blocks(lin, consts.chain, consts.chain_i, free_p)
    V2 = X2 = K_lu = K_piv = None
    if consts.use_woodbury:
        # M = T - V A^-1 V^T, the chain with the FULL landmark arrow: exactly S
        # when Hpp has no off-chain blocks. M^-1 = T^-1 + T^-1 V K^-1 V^T T^-1
        # with K = A - V^T T^-1 V (2 NL x 2 NL, dense: landmarks are few)
        fac = cr_factor(L_pre, _damped_blocks(Dp, lam, free_p, 3), U_pre)
        Vd = _landmark_arrow(C, consts.arrow, free_p, NP, NL)
        X = cr_solve(fac, Vd)  # T^-1 V, multi-column cyclic reduction
        # V and X as (3 NP, 2 NL) matrices: their products need no copies
        V2, X2 = Vd.reshape(3 * NP, 2 * NL), X.reshape(3 * NP, 2 * NL)
        K = _block_diag(_damped_blocks(Dl, lam, free_l, 2)) - V2.T @ X2
        K_lu, K_piv, _ = torch.linalg.lu_factor_ex(K)
    else:
        fac = cr_factor(L_pre, _damped_blocks(Dp - corr, lam, free_p, 3), U_pre)
    return SchurSystem(bs, C, Hll_inv, ybl, diagDp, zeros_l, fac, V2, X2, K_lu, K_piv)


def schur_operators(g: PoseGraph2D, lin, lam, sys: SchurSystem, consts: SchurConsts):
    """(smv, precond, recover_dl) of a `SchurSystem`.

    smv applies the landmark-eliminated damped Schur operator
    ``S_d = Hpp + lam diag(Hpp) - Hpl Hll_d^-1 Hlp`` to pose block-vectors;
    precond applies ``M^-1``, M either T - V A^-1 V^T (the chain
    tridiagonal with the exact landmark arrow, through Woodbury) or the
    Schur-corrected chain tridiagonal; recover_dl back-substitutes the
    landmark increments. They launch nothing until called.
    """
    NP = consts.NP
    free_p, free_l, pose_k, lm_k, seg = consts.free_p, consts.free_l, consts.pose_k, consts.lm_k, consts.seg
    C, Hll_inv, fac = sys.C, sys.Hll_inv, sys.fac
    edge_hvp = pg._hvp_edges_se2(g, lin, seg)

    def smv(v):
        vp = v[0] * free_p[:, None]
        # the pose slot of the edge product with vl = 0 is Hpp v
        hp, _ = edge_hvp((vp, sys.zeros_l))
        hp = hp + lam * sys.diagDp * vp
        if consts.has_pl:
            t = ss.segment_sum(torch.einsum("kji,kj->ki", C, vp[pose_k]), seg.pl_l)
            y = torch.einsum("lij,lj->li", Hll_inv, t)
            hp = hp - ss.segment_sum(torch.einsum("kij,kj->ki", C, y[lm_k]), seg.pl_p)
        return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

    if consts.use_woodbury:
        def precond(r):
            z = cr_solve(fac, r[0])
            u = torch.linalg.lu_solve(sys.K_lu, sys.K_piv, (z.reshape(1, -1) @ sys.V2).T)
            return (z + (sys.X2 @ u).reshape(NP, 3),)

    else:
        def precond(r):
            return (cr_solve(fac, r[0]),)

    def recover_dl(dp):
        if not consts.has_pl:
            return sys.zeros_l
        t = ss.segment_sum(torch.einsum("kji,kj->ki", C, dp[pose_k]), seg.pl_l)
        return (sys.ybl - torch.einsum("lij,lj->li", Hll_inv, t)) * free_l[:, None]

    return smv, precond, recover_dl


def landmark_covariance_se2(g: PoseGraph2D, lam: float = 1e-6, huber_delta: float | None = None):
    """`_landmark_covariance_se2`, the JAX package's jitted function: on the
    card one captured stage (`utils.graphs.Stage`), captured at the second
    call of a key so that a graph whose counts are seen once pays no
    capture."""
    return _COVARIANCE(g, lam, huber_delta)


def _landmark_covariance_se2(g: PoseGraph2D, lam: float, huber_delta: float | None):
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
    Vd = _landmark_arrow(C, _arrow_index(g.pl_ij[:, 0], g.pl_ij[:, 1], NP, NL), free_p, NP, NL)
    X = cr_solve(fac, Vd)
    K = _block_diag(_damped_blocks(Dl, lam, free_l, 2)) - Vd.reshape(3 * NP, 2 * NL).T @ X.reshape(3 * NP, 2 * NL)
    return pg._inv(K).reshape(NL, 2, NL, 2)


_COVARIANCE = graphs.Stage("landmark_covariance_se2", _landmark_covariance_se2, second_call=True)


class _Params(NamedTuple):
    """A Schur solve's static parameters (part of its graphs' key)."""

    huber_delta: float | None
    tol: float
    cg_rtol: float
    cg_iters: int


class _Mid(NamedTuple):
    lin: pg.Linearization
    sys: SchurSystem
    lam: torch.Tensor
    tol2: torch.Tensor


def _head(inputs, st: pg.LMState):
    """Linearize, build the reduced system, start CG."""
    g, consts, prm = inputs
    gk = g.with_poses(st.poses, st.lms)
    lin = pg.linearize_se2(gk, prm.huber_delta)
    sys = schur_system(gk, lin, st.lam, consts)
    _, precond, _ = schur_operators(g, lin, st.lam, sys, consts)
    carry, tol2 = cg_carry((sys.bs,), precond, prm.cg_rtol)
    return _Mid(lin, sys, st.lam, tol2), carry


def _operators(cs):
    (g, consts, _), mid = cs
    smv, precond, _ = schur_operators(g, mid.lin, mid.lam, mid.sys, consts)
    return smv, precond


def _tail(inputs, st: pg.LMState, mid: _Mid, carry) -> pg.LMState:
    """Back-substitute the landmarks, relinearize, accept or reject, and
    update lambda, nu, the trace and the convergence test."""
    g, consts, prm = inputs
    _, _, recover_dl = schur_operators(g, mid.lin, mid.lam, mid.sys, consts)
    lin, free_p = mid.lin, consts.free_p
    dp = carry.x[0] * free_p[:, None]
    dl = recover_dl(dp)
    new_poses = st.poses + dp
    new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
    new_lms = st.lms + dl
    lin_new = pg.linearize_se2(g.with_poses(new_poses, new_lms), prm.huber_delta)
    accept = torch.isfinite(lin_new.chi2) & (lin_new.chi2 < lin.chi2)
    rel_drop = (lin.chi2 - lin_new.chi2) / torch.clamp_min(lin.chi2, 1e-30)
    done = (accept & (rel_drop < prm.tol)) | (~accept & (st.lam >= 1e10))
    lam, nu = (torch.where(accept, torch.clamp_min(st.lam / 3.0, 1e-12), torch.clamp_max(st.lam * st.nu, 1e10)),
               torch.where(accept, 2.0, torch.clamp_max(st.nu * 2.0, 64.0)))
    poses = torch.where(accept, new_poses, st.poses)
    lms = torch.where(accept, new_lms, st.lms)
    trace = pg.trace_put(st.trace, st.k, torch.where(accept, lin_new.chi2, lin.chi2))
    return pg.LMState(poses, lms, lam, trace, st.k + 1, st.cg_total + carry.k, nu, done)


def _report(st: pg.LMState):
    return torch.stack([st.done.to(torch.int64), st.k, st.cg_total])


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
    arrow while 2 NL <= 2048.

    The LM iteration runs as `utils.graphs.solve_loop` runs a solve: a
    head (linearization, reduced system, CG start), CG in blocks of
    `pcg.BLOCK` masked steps with the JAX stopping test on the device, and
    a tail (the step, accept / reject, lambda, the trace); on the card a
    graph each, one host read a CG block and one an LM iteration (the
    convergence test with the counts)."""
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    has_pl = g.pl_ij.shape[0] > 0
    use_woodbury = (has_pl and 2 * NL <= WOODBURY_MAX_DIM) if woodbury is None else (woodbury and has_pl)
    chain, chain_i = pg._chain(g)
    pose_k, lm_k = (g.pl_ij[:, 0], g.pl_ij[:, 1]) if has_pl else (None, None)
    consts = SchurConsts(NP, NL, has_pl, use_woodbury, free_p, free_l, pose_k, lm_k, pg.edge_segments(g),
                         _arrow_index(pose_k, lm_k, NP, NL) if use_woodbury else None, chain, chain_i)
    state = pg._start(g.poses, pg.linearize_se2(g, huber_delta).chi2, lm_lambda0, iters, g.landmarks, stops=True)
    solve = graphs.Solve(_head, _tail, _report, cg_loop(_operators, lambda cs: cs[1].tol2, cg_iters), stops=True)
    st, (_, k, cg_total) = graphs.solve_loop("optimize_se2_schur", solve,
                                             (g, consts, _Params(huber_delta, tol, cg_rtol, cg_iters)), state, iters)
    return g.with_poses(st.poses, st.lms), SchurStats(st.trace, st.lam, cg_total, k)
