"""Levenberg-Marquardt pose-graph optimization (counterpart of
``g2o_frontend_tpu/solvers/pose_graph.py``).

Residuals follow g2o:

- SE2 pose-pose ``e = t2v(Z^-1 (Xi^-1 Xj))`` (3,), SE2 pose-landmark
  ``e = R_i^T (l - t_i) - z`` (2,), with additive updates of the
  ``[x, y, theta]`` chart;
- SE3 pose-pose ``e = log(Z^-1 (Xi^-1 Xj))`` in the se(3) twist chart, with
  right-multiplicative local updates ``X <- X exp(dx)`` (g2o's EdgeSE3).

Jacobians: SE2 in closed form (the JAX version's ``jacfwd`` of the same
residuals; the angle wrap has derivative 1); SE3 by forward-mode
differentiation (`torch.func.jacfwd`). Every SE3 edge's residual depends on
its own local twists only, so differentiating the whole batch with respect
to ONE shared 6-vector gives each edge's (6, 6) Jacobian at once: the
batched equivalent of ``vmap(jacfwd)``.

Gradient, block diagonal and Hessian-vector products are assembled with
`ops.segment_sum` (JAX's ``segment_sum``): each solve sorts its edge
indices once (`edge_segments`), and every sum then adds a vertex's edges
in their order, on the card by a kernel with no atomics, so a solve
repeats bit for bit. The Newton system is solved
matrix-free by PCG (`pcg.py`) with a block-Jacobi or a chain
(block-tridiagonal, `tridiag.py`) preconditioner, or, in
`optimize_se2_direct`, by a dense Cholesky factor. Gauge freedom is handled
by projecting the fixed and masked DOFs out. LM damping with accept/reject
stays on the device (``torch.where``); the host reads PCG's stopping test
once a CG iteration, and `optimize_se2_direct` reads its convergence test
once an LM iteration (JAX's ``lax.while_loop`` condition).

The graph's tensors set the device. Float32 matrix products must run in
full float32 (the JAX version pins ``"highest"`` precision for this):
importing the package turns TF32 off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..graph.store import PoseGraph2D, PoseGraph3D
from ..ops import segment_sum as ss
from ..utils import lie
from .pcg import pcg
from .tridiag import cr_factor, cr_solve

PRECONDITIONERS = ("jacobi", "chain")


class Linearization(NamedTuple):
    """Per-edge residuals and Jacobians, plus weights (robust-scaled)."""

    e_pp: torch.Tensor  # (EP, D)
    Ji_pp: torch.Tensor  # (EP, D, D)
    Jj_pp: torch.Tensor  # (EP, D, D)
    w_pp: torch.Tensor  # (EP, D, D)  information (robust-scaled, masked)
    e_pl: torch.Tensor | None  # (EL, 2)
    Jp_pl: torch.Tensor | None  # (EL, 2, 3)
    Jl_pl: torch.Tensor | None  # (EL, 2, 2)
    w_pl: torch.Tensor | None  # (EL, 2, 2)
    chi2: torch.Tensor  # () robust chi2, masked


class OptStats(NamedTuple):
    chi2: torch.Tensor  # (iters+1,) robust chi2 trace (padded with the last value)
    lm_lambda: torch.Tensor  # final lambda
    cg_iters: int  # total CG iterations (optimize_se2_direct: LM iterations run)


def _robust_scale(chi2, huber_delta):
    """Huber weight factor on the information matrix; None disables."""
    if huber_delta is None:
        return torch.ones_like(chi2)
    d2 = huber_delta * huber_delta
    return torch.where(chi2 > d2, torch.sqrt(d2 / torch.clamp_min(chi2, 1e-30)), 1.0)


def _weigh(e, info, mask, huber_delta):
    """(robust-scaled masked information, the edges' robust chi2 sum)."""
    chi2 = torch.einsum("ki,kij,kj->k", e, info, e)
    s = _robust_scale(chi2, huber_delta)
    return info * (s * mask)[:, None, None], torch.where(mask, s * chi2, 0.0).sum()


class EdgeSegments(NamedTuple):
    """The segment indices of an SE2 graph's edge ends, built once a solve:
    pose-pose edges by their first and second pose, pose-landmark edges
    by their pose and their landmark."""

    pp_i: ss.SegmentIndex
    pp_j: ss.SegmentIndex
    pl_p: ss.SegmentIndex
    pl_l: ss.SegmentIndex


def edge_segments(g) -> EdgeSegments:
    """`EdgeSegments` of a graph (or any namespace with poses, landmarks,
    pp_ij and pl_ij)."""
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    return EdgeSegments(ss.SegmentIndex(g.pp_ij[:, 0], NP), ss.SegmentIndex(g.pp_ij[:, 1], NP),
                        ss.SegmentIndex(g.pl_ij[:, 0], NP), ss.SegmentIndex(g.pl_ij[:, 1], NL))


# -- SE2 ----------------------------------------------------------------------------


def se2_pp_residual(xi, xj, z):
    """(E, 3) pose-pose residuals, the angle wrapped."""
    e = lie.se2_relative(xi, xj) - z
    return torch.cat([e[:, :2], lie.wrap_angle(e[:, 2:])], 1)


def se2_pl_residual(xi, l, z):
    """(E, 2) pose-landmark residuals."""
    c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dx, dy = l[:, 0] - xi[:, 0], l[:, 1] - xi[:, 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], 1) - z


def _rot_rows(c, s):
    """(E, 2, 2) R^T = [[c, s], [-s, c]]."""
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


def _se2_point_jacobians(xi, p):
    """d/dxi and d/dp of R_i^T (p - t_i): (E, 2, 3) and (E, 2, 2)."""
    c, s = torch.cos(xi[:, 2]), torch.sin(xi[:, 2])
    dx, dy = p[:, 0] - xi[:, 0], p[:, 1] - xi[:, 1]
    Rt = _rot_rows(c, s)
    dth = torch.stack([-s * dx + c * dy, -c * dx - s * dy], -1)[..., None]
    return torch.cat([-Rt, dth], -1), Rt


def linearize_se2(g: PoseGraph2D, huber_delta=None) -> Linearization:
    xi, xj = g.poses[g.pp_ij[:, 0]], g.poses[g.pp_ij[:, 1]]
    e_pp = se2_pp_residual(xi, xj, g.pp_meas)
    Jt, Rt = _se2_point_jacobians(xi, xj[:, :2])
    angle_row = xi.new_tensor([0.0, 0.0, 1.0]).expand(xi.shape[0], 1, 3)  # d wrap(th_j - th_i - z)
    Ji_pp = torch.cat([Jt, -angle_row], 1)
    Jj_pp = torch.cat([F.pad(Rt, (0, 1)), angle_row], 1)
    w_pp, total = _weigh(e_pp, g.pp_info, g.pp_mask, huber_delta)

    e_pl = Jp_pl = Jl_pl = w_pl = None
    if g.pl_ij.shape[0] > 0:
        xp, ll = g.poses[g.pl_ij[:, 0]], g.landmarks[g.pl_ij[:, 1]]
        e_pl = se2_pl_residual(xp, ll, g.pl_meas)
        Jp_pl, Jl_pl = _se2_point_jacobians(xp, ll)
        w_pl, total_pl = _weigh(e_pl, g.pl_info, g.pl_mask, huber_delta)
        total = total + total_pl
    return Linearization(e_pp, Ji_pp, Jj_pp, w_pp, e_pl, Jp_pl, Jl_pl, w_pl, total)


def _grad_se2(g: PoseGraph2D, lin: Linearization, seg: EdgeSegments | None = None):
    seg = edge_segments(g) if seg is None else seg
    we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
    gp = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), seg.pp_i)
    gp = gp + ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jj_pp, we), seg.pp_j)
    gl = g.poses.new_zeros((seg.pl_l.n, 2))
    if lin.e_pl is not None:
        we_pl = torch.einsum("kij,kj->ki", lin.w_pl, lin.e_pl)
        gp = gp + ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jp_pl, we_pl), seg.pl_p)
        gl = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jl_pl, we_pl), seg.pl_l)
    return gp, gl


def _jtwj(Ja, w, Jb):
    return torch.einsum("kdi,kde,kej->kij", Ja, w, Jb)


def _diag_blocks_se2(g: PoseGraph2D, lin: Linearization, seg: EdgeSegments | None = None):
    seg = edge_segments(g) if seg is None else seg
    Dp = ss.segment_sum(_jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), seg.pp_i)
    Dp = Dp + ss.segment_sum(_jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp), seg.pp_j)
    Dl = g.poses.new_zeros((seg.pl_l.n, 2, 2))
    if lin.e_pl is not None:
        Dp = Dp + ss.segment_sum(_jtwj(lin.Jp_pl, lin.w_pl, lin.Jp_pl), seg.pl_p)
        Dl = ss.segment_sum(_jtwj(lin.Jl_pl, lin.w_pl, lin.Jl_pl), seg.pl_l)
    return Dp, Dl


def _hvp_edges_se2(g: PoseGraph2D, lin: Linearization, seg: EdgeSegments | None = None):
    """The pure per-edge Gauss-Newton product ``sum_e J^T W J v``: no
    damping and no gauge handling."""
    seg = edge_segments(g) if seg is None else seg
    I, J = g.pp_ij[:, 0], g.pp_ij[:, 1]

    def hvp(v):
        vp, vl = v
        Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
        WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
        hp = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), seg.pp_i)
        hp = hp + ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv), seg.pp_j)
        hl = vp.new_zeros((seg.pl_l.n, 2))
        if lin.e_pl is not None:
            P, L = g.pl_ij[:, 0], g.pl_ij[:, 1]
            Jv2 = torch.einsum("kdi,ki->kd", lin.Jp_pl, vp[P]) + torch.einsum("kdi,ki->kd", lin.Jl_pl, vl[L])
            WJv2 = torch.einsum("kde,ke->kd", lin.w_pl, Jv2)
            hp = hp + ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jp_pl, WJv2), seg.pl_p)
            hl = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Jl_pl, WJv2), seg.pl_l)
        return hp, hl

    return hvp


def _compose_hvp(edge_hvp, free_p, free_l, lm_lambda, Dp, Dl):
    """LM damping on the diagonal blocks and an identity action on the fixed
    and masked DOFs (the gauge projection) around the edge product."""

    def hvp(v):
        vp, vl = v[0] * free_p[:, None], v[1] * free_l[:, None]
        hp, hl = edge_hvp((vp, vl))
        hp = hp + lm_lambda * torch.einsum("kij,kj->ki", Dp, vp)
        hl = hl + lm_lambda * torch.einsum("kij,kj->ki", Dl, vl)
        hp = hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0]
        hl = hl * free_l[:, None] + (1.0 - free_l)[:, None] * v[1]
        return hp, hl

    return hvp


def _inv(A):
    return torch.linalg.inv_ex(A, check_errors=False).inverse


def _damped(D, lam, free):
    """(1 + lam) D + 1e-6 I on free blocks, I on the others."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return torch.where(free[:, None, None] > 0, (1.0 + lam) * D + 1e-6 * eye, eye)


def _damped_inverse(D, lam, free):
    return _inv(_damped(D, lam, free))


def _block_jacobi_precond(Dp, Dl, free_p, free_l, lm_lambda):
    Dp_inv, Dl_inv = _damped_inverse(Dp, lm_lambda, free_p), _damped_inverse(Dl, lm_lambda, free_l)

    def precond(r):
        return torch.einsum("kij,kj->ki", Dp_inv, r[0]), torch.einsum("kij,kj->ki", Dl_inv, r[1])

    return precond


def _chain(g):
    """The odometry-chain slots: pose-pose edge k couples U[i] iff j == i+1;
    the others go to the dump slot NP (their `SegmentIndex`). The JAX
    version sums them into the last slot, which `_chain_blocks` zeroes."""
    I, J = g.pp_ij[:, 0], g.pp_ij[:, 1]
    chain = (J == I + 1) & g.pp_mask
    NP = g.poses.shape[0]
    return chain, ss.SegmentIndex(torch.where(chain, I, NP), NP)


def _chain_blocks(lin, chain, chain_i, free_p):
    """(L, U) off-diagonal blocks of the chain's block-tridiagonal part,
    zero where either end is fixed or masked."""
    d = lin.Ji_pp.shape[-1]
    U = ss.segment_sum(_jtwj(lin.Ji_pp, lin.w_pp * chain[:, None, None], lin.Jj_pp), chain_i)
    fnext = torch.cat([free_p[1:], free_p.new_zeros(1)])
    U = U * (free_p * fnext)[:, None, None]
    return torch.cat([U.new_zeros((1, d, d)), U.transpose(1, 2)[:-1]]), U


def optimize_se2(
    g: PoseGraph2D,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    huber_delta: float | None = None,
    precond: str = "jacobi",
) -> tuple[PoseGraph2D, OptStats]:
    """LM-optimize an SE2 pose graph (poses and landmarks).

    precond: "jacobi" (the point-block diagonal) or "chain" (the
    block-tridiagonal odometry-chain factor by cyclic reduction on the pose
    block, block-Jacobi on the landmarks).
    """
    if precond not in PRECONDITIONERS:
        raise ValueError(f"precond must be one of {PRECONDITIONERS}, got {precond!r}")
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    if precond == "chain":
        chain, chain_i = _chain(g)
    seg = edge_segments(g)

    trace = [linearize_se2(g, huber_delta).chi2]
    poses, lms = g.poses, g.landmarks
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=g.poses.device)
    cg_total = 0
    for _ in range(iters):
        gk = g.with_poses(poses, lms)
        lin = linearize_se2(gk, huber_delta)
        gp, gl = _grad_se2(gk, lin, seg)
        Dp, Dl = _diag_blocks_se2(gk, lin, seg)
        hvp = _compose_hvp(_hvp_edges_se2(gk, lin, seg), free_p, free_l, lam, Dp, Dl)
        if precond == "chain":
            L_pre, U_pre = _chain_blocks(lin, chain, chain_i, free_p)
            fac, Dl_inv = cr_factor(L_pre, _damped(Dp, lam, free_p), U_pre), _damped_inverse(Dl, lam, free_l)

            def pre(r, fac=fac, Dl_inv=Dl_inv):
                return cr_solve(fac, r[0]), torch.einsum("kij,kj->ki", Dl_inv, r[1])

        else:
            pre = _block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
        (dp, dl), cg_k, _ = pcg(hvp, (-gp * free_p[:, None], -gl * free_l[:, None]), pre, max_iters=cg_iters,
                                rtol=1e-8)
        new_poses = poses + dp * free_p[:, None]
        new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
        new_lms = lms + dl * free_l[:, None]
        lin_new = linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        accept = lin_new.chi2 < lin.chi2
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, lin_new.chi2, lin.chi2))
        cg_total += cg_k
    return g.with_poses(poses, lms), OptStats(torch.stack(trace), lam, cg_total)


def _dense_plan(g: PoseGraph2D):
    """The flat (D, D) and (D,) targets of `_dense_system`'s blocks, in its
    order of addition, as segment indices: built once a solve. The (D, D)
    index is compacted to the entries that some edge touches."""
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    D = 3 * NP + 2 * NL
    dev = g.poses.device
    H_idx, b_idx = [], []

    def add(r0, c0, nr, nc):
        rd, cd = torch.arange(nr, device=dev), torch.arange(nc, device=dev)
        H_idx.append(((r0[:, None, None] + rd[None, :, None]) * D + (c0[:, None, None] + cd[None, None, :])).reshape(-1))

    def add_b(r0, nr):
        b_idx.append((r0[:, None] + torch.arange(nr, device=dev)[None]).reshape(-1))

    i0, j0 = 3 * g.pp_ij[:, 0], 3 * g.pp_ij[:, 1]
    for r0, c0 in ((i0, i0), (i0, j0), (j0, i0), (j0, j0)):
        add(r0, c0, 3, 3)
    add_b(i0, 3)
    add_b(j0, 3)
    if g.pl_ij.shape[0] > 0:
        p0, l0 = 3 * g.pl_ij[:, 0], 3 * NP + 2 * g.pl_ij[:, 1]
        for (r0, nr), (c0, nc) in (((p0, 3), (p0, 3)), ((p0, 3), (l0, 2)), ((l0, 2), (p0, 3)), ((l0, 2), (l0, 2))):
            add(r0, c0, nr, nc)
        add_b(p0, 3)
        add_b(l0, 2)
    H_ids, H_seg = ss.compact_index(torch.cat(H_idx))
    return D, H_ids, H_seg, ss.SegmentIndex(torch.cat(b_idx), D)


def _dense_system(g: PoseGraph2D, lin: Linearization, plan=None):
    """The full Gauss-Newton system as a dense (D, D) matrix and (D,)
    vector, D = 3 NP + 2 NL, assembled by segment sums over `_dense_plan`'s
    targets (each entry adds its blocks in the plan's order)."""
    D, H_ids, H_seg, b_seg = _dense_plan(g) if plan is None else plan
    blocks, vecs = [], []
    WJi = torch.einsum("kde,kei->kdi", lin.w_pp, lin.Ji_pp)
    WJj = torch.einsum("kde,kei->kdi", lin.w_pp, lin.Jj_pp)
    blocks += [torch.einsum("kdi,kdj->kij", lin.Ji_pp, WJi), torch.einsum("kdi,kdj->kij", lin.Ji_pp, WJj),
               torch.einsum("kdi,kdj->kij", lin.Jj_pp, WJi), torch.einsum("kdi,kdj->kij", lin.Jj_pp, WJj)]
    We = torch.einsum("kde,ke->kd", lin.w_pp, lin.e_pp)
    vecs += [torch.einsum("kdi,kd->ki", lin.Ji_pp, We), torch.einsum("kdi,kd->ki", lin.Jj_pp, We)]
    if lin.e_pl is not None:
        WJp = torch.einsum("kde,kei->kdi", lin.w_pl, lin.Jp_pl)
        WJl = torch.einsum("kde,kei->kdi", lin.w_pl, lin.Jl_pl)
        blocks += [torch.einsum("kdi,kdj->kij", lin.Jp_pl, WJp), torch.einsum("kdi,kdj->kij", lin.Jp_pl, WJl),
                   torch.einsum("kdi,kdj->kij", lin.Jl_pl, WJp), torch.einsum("kdi,kdj->kij", lin.Jl_pl, WJl)]
        Wep = torch.einsum("kde,ke->kd", lin.w_pl, lin.e_pl)
        vecs += [torch.einsum("kdi,kd->ki", lin.Jp_pl, Wep), torch.einsum("kdi,kd->ki", lin.Jl_pl, Wep)]
    H = lin.e_pp.new_zeros(D * D)
    H[H_ids] = ss.segment_sum(torch.cat([x.reshape(-1) for x in blocks]), H_seg)
    b = ss.segment_sum(torch.cat([x.reshape(-1) for x in vecs]), b_seg)
    return H.view(D, D), b


def optimize_se2_direct(
    g: PoseGraph2D,
    iters: int = 30,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
) -> tuple[PoseGraph2D, OptStats]:
    """LM with dense Cholesky solves: exact Newton steps.

    Truncated PCG steps converge slowly on long-chain graphs with sparse
    loop closures; a dense factor of the full system takes the exact step
    while the (D, D) float32 Hessian fits the device (21,662 DOF: 1.9 GB).
    Each step is refined twice through the factor, which removes the
    rounding that float32 Cholesky leaves on a chain-conditioned system.
    The lambda schedule is Nielsen's, and the loop stops on convergence:
    the one host read of an LM iteration is that test. The returned stats'
    `cg_iters` is the number of LM iterations run.
    """
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    free = torch.cat([free_p.repeat_interleave(3), free_l.repeat_interleave(2)])

    trace = [linearize_se2(g, huber_delta).chi2]
    poses, lms = g.poses, g.landmarks
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=g.poses.device)
    nu = torch.full_like(lam, 2.0)
    plan = _dense_plan(g)
    k = 0
    while k < iters:
        lin = linearize_se2(g.with_poses(poses, lms), huber_delta)
        H, b = _dense_system(g, lin, plan)
        # gauge and mask projection: fixed or padded DOFs become identity rows
        Hd = H.mul_(free[:, None] * free[None, :])
        diag = Hd.diagonal()
        diag.add_(lam * diag + (1.0 - free) + 1e-6 * free)
        L = torch.linalg.cholesky_ex(Hd, check_errors=False).L
        rhs = (-b * free)[:, None]
        dx = torch.cholesky_solve(rhs, L)
        for _ in range(2):
            dx = dx + torch.cholesky_solve(rhs - Hd @ dx, L)
        dx = dx[:, 0] * free
        new_poses = poses + dx[: 3 * NP].reshape(NP, 3)
        new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
        new_lms = lms + dx[3 * NP:].reshape(NL, 2)
        del H, Hd, diag, L
        lin_new = linearize_se2(g.with_poses(new_poses, new_lms), huber_delta)
        ok = torch.isfinite(lin_new.chi2) & (lin_new.chi2 < lin.chi2)
        poses = torch.where(ok, new_poses, poses)
        lms = torch.where(ok, new_lms, lms)
        lam = torch.where(ok, torch.clamp_min(lam / 3.0, 1e-12), torch.clamp_max(lam * nu, 1e10))
        nu = torch.where(ok, 2.0, torch.clamp_max(nu * 2.0, 64.0))
        rel_drop = (lin.chi2 - lin_new.chi2) / torch.clamp_min(lin.chi2, 1e-30)
        done = (ok & (rel_drop < 1e-9)) | (~ok & (lam >= 1e10))
        trace.append(torch.where(ok, lin_new.chi2, lin.chi2))
        k += 1
        if bool(done):
            break
    trace += [trace[-1]] * (iters + 1 - len(trace))
    return g.with_poses(poses, lms), OptStats(torch.stack(trace), lam, k)


def chi2_se2(g: PoseGraph2D) -> torch.Tensor:
    return linearize_se2(g).chi2


# -- SE3 ----------------------------------------------------------------------------


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


def linearize_se3(g: PoseGraph3D, huber_delta=None) -> Linearization:
    Ti = _pose7_to_T(g.poses[g.pp_ij[:, 0]])
    Tj = _pose7_to_T(g.poses[g.pp_ij[:, 1]])
    Zinv = lie.se3_inverse(_pose7_to_T(g.pp_meas))
    zero = torch.zeros(6, dtype=g.poses.dtype, device=g.poses.device)
    e = se3_pp_residual_local(zero, zero, Ti, Tj, Zinv)
    Ji = torch.func.jacfwd(lambda d: se3_pp_residual_local(d, zero, Ti, Tj, Zinv))(zero)
    Jj = torch.func.jacfwd(lambda d: se3_pp_residual_local(zero, d, Ti, Tj, Zinv))(zero)
    w, total = _weigh(e, g.pp_info, g.pp_mask, huber_delta)
    return Linearization(e, Ji, Jj, w, None, None, None, None, total)


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
    I_seg, J_seg = ss.SegmentIndex(I, NP), ss.SegmentIndex(J, NP)
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    if precond == "chain":
        chain, chain_i = _chain(g)

    trace = [linearize_se3(g, huber_delta).chi2]
    poses = g.poses
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=g.poses.device)
    cg_total = 0
    for _ in range(iters):
        lin = linearize_se3(g.with_poses(poses), huber_delta)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), I_seg) + ss.segment_sum(
            torch.einsum("kdi,kd->ki", lin.Jj_pp, we), J_seg
        )
        Dp = ss.segment_sum(_jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), I_seg) + ss.segment_sum(
            _jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp), J_seg
        )

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            (vp,) = v
            vp = vp * free_p[:, None]
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), I_seg) + ss.segment_sum(
                torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv), J_seg
            )
            hp = hp + lam * torch.einsum("kij,kj->ki", Dp, vp)
            return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * vp,)

        Dp_d = _damped(Dp, lam, free_p)
        if precond == "chain":
            L_pre, U_pre = _chain_blocks(lin, chain, chain_i, free_p)
            fac = cr_factor(L_pre, Dp_d, U_pre)

            def pre(r, fac=fac):
                return (cr_solve(fac, r[0]),)

        else:
            Dp_inv = _inv(Dp_d)

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
