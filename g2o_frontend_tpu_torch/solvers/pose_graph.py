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
stays on the device (``torch.where``). Each solve runs through
`utils.graphs.solve_loop` as JAX runs its ``fori_loop`` / ``while_loop``:
on the card a graph for an LM iteration's head, one for each block of
`pcg.BLOCK` masked CG steps (the stopping test computed on the device, read
once a block) and one for its tail; `optimize_se3`'s head ends with its
whole CG, one launch of the kernel of `ops.se3_pcg`, so it runs no CG
block and reads nothing until the solve's end, and its start and tail
take chi2 alone (`chi2_se3`, the start a captured `graphs.Stage`);
`optimize_se2_direct` reads its convergence test once an LM iteration.

The graph's tensors set the device. Float32 matrix products must run in
full float32 (the JAX version pins ``"highest"`` precision for this):
importing the package turns TF32 off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..graph.store import PoseGraph2D, PoseGraph3D
from ..ops import se3_pcg
from ..ops import segment_sum as ss
from ..utils import graphs, lie
from .pcg import cg_carry, cg_loop
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


def masked_segments(index, mask, n) -> ss.SegmentIndex:
    """The `SegmentIndex` of `index` into n rows with the masked-off rows
    (a padded graph's padding, which joins row 0 to row 0 with zero
    information) sent to the dump slot: they add nothing, and row 0 does
    not become one long segment of zeros."""
    return ss.SegmentIndex(torch.where(mask, index, n), n)


def edge_segments(g, n_landmarks: int | None = None) -> EdgeSegments:
    """`EdgeSegments` of a graph (or any object with poses, pp_ij, pl_ij,
    pp_mask, pl_mask, and landmarks unless `n_landmarks` is given)."""
    NP = g.poses.shape[0]
    NL = g.landmarks.shape[0] if n_landmarks is None else n_landmarks
    return EdgeSegments(masked_segments(g.pp_ij[:, 0], g.pp_mask, NP), masked_segments(g.pp_ij[:, 1], g.pp_mask, NP),
                        masked_segments(g.pl_ij[:, 0], g.pl_mask, NP), masked_segments(g.pl_ij[:, 1], g.pl_mask, NL))


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
    # d wrap(th_j - th_i - z), made on the device (a host-made row is a copy a CUDA graph cannot capture)
    angle_row = F.pad(xi.new_ones((1, 1, 1)), (2, 0)).expand(xi.shape[0], 1, 3)
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


class LMState(NamedTuple):
    """The LM state of a solve, on the device: `trace` holds the initial
    chi2 and one entry an iteration, `k` the iterations run; `cg_total` the
    CG iterations where a solve runs CG; `nu` and `done` (Nielsen's
    schedule, the convergence test) where it stops on convergence; `lms`
    None for SE3."""

    poses: torch.Tensor
    lms: torch.Tensor | None
    lam: torch.Tensor
    trace: torch.Tensor
    k: torch.Tensor
    cg_total: torch.Tensor | None = None
    nu: torch.Tensor | None = None
    done: torch.Tensor | None = None


def trace_put(trace, k, value):
    """The chi2 trace with `value` at k + 1 and every later entry: the
    entries after the last iteration carry its value, as JAX pads."""
    return torch.where(torch.arange(trace.shape[0], device=trace.device) > k, value, trace)


def _start(poses, chi2, lm_lambda0, iters, landmarks=None, cg=True, stops=False):
    """An `LMState` at `poses`, lambda0 and `chi2` (the trace's first entry
    and its padding)."""
    lam = torch.tensor(lm_lambda0, dtype=poses.dtype, device=poses.device)
    zero = torch.zeros((), dtype=torch.int64, device=poses.device)
    return LMState(poses, landmarks, lam, chi2.expand(iters + 1).clone(), zero, zero if cg else None,
                   torch.full_like(lam, 2.0) if stops else None,
                   torch.zeros((), dtype=torch.bool, device=poses.device) if stops else None)


def _cg_report(st):
    return st.cg_total.reshape(1)


class _SE2Consts(NamedTuple):
    free_p: torch.Tensor
    free_l: torch.Tensor
    seg: EdgeSegments
    chain: torch.Tensor | None
    chain_i: ss.SegmentIndex | None


class _Params(NamedTuple):
    """A solve's static parameters (part of its graphs' key)."""

    huber_delta: float | None
    precond: str
    cg_iters: int


class _Mid(NamedTuple):
    lin: Linearization
    Dp: torch.Tensor
    Dl: torch.Tensor | None
    lam: torch.Tensor
    pre: tuple  # the preconditioner's tensors
    tol2: torch.Tensor


def _se2_head(inputs, st: LMState):
    """Linearize, the gradient and block diagonal, the preconditioner,
    start CG."""
    g, c, prm = inputs
    gk = g.with_poses(st.poses, st.lms)
    lin = linearize_se2(gk, prm.huber_delta)
    gp, gl = _grad_se2(gk, lin, c.seg)
    Dp, Dl = _diag_blocks_se2(gk, lin, c.seg)
    if prm.precond == "chain":
        L_pre, U_pre = _chain_blocks(lin, c.chain, c.chain_i, c.free_p)
        pre = (cr_factor(L_pre, _damped(Dp, st.lam, c.free_p), U_pre), _damped_inverse(Dl, st.lam, c.free_l))
    else:
        pre = (_damped_inverse(Dp, st.lam, c.free_p), _damped_inverse(Dl, st.lam, c.free_l))
    mid = _Mid(lin, Dp, Dl, st.lam, pre, None)
    carry, tol2 = cg_carry((-gp * c.free_p[:, None], -gl * c.free_l[:, None]), _se2_operators(((g, c, prm), mid))[1],
                           1e-8)
    return mid._replace(tol2=tol2), carry


def _se2_operators(cs):
    (g, c, prm), mid = cs
    hvp = _compose_hvp(_hvp_edges_se2(g, mid.lin, c.seg), c.free_p, c.free_l, mid.lam, mid.Dp, mid.Dl)
    if prm.precond == "chain":
        fac, Dl_inv = mid.pre

        def pre(r):
            return cr_solve(fac, r[0]), torch.einsum("kij,kj->ki", Dl_inv, r[1])

    else:
        Dp_inv, Dl_inv = mid.pre

        def pre(r):
            return torch.einsum("kij,kj->ki", Dp_inv, r[0]), torch.einsum("kij,kj->ki", Dl_inv, r[1])

    return hvp, pre


def _se2_tail(inputs, st: LMState, mid: _Mid, carry) -> LMState:
    g, c, prm = inputs
    dp, dl = carry.x
    new_poses = st.poses + dp * c.free_p[:, None]
    new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
    new_lms = st.lms + dl * c.free_l[:, None]
    lin_new = linearize_se2(g.with_poses(new_poses, new_lms), prm.huber_delta)
    accept = lin_new.chi2 < mid.lin.chi2
    poses = torch.where(accept, new_poses, st.poses)
    lms = torch.where(accept, new_lms, st.lms)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = trace_put(st.trace, st.k, torch.where(accept, lin_new.chi2, mid.lin.chi2))
    return LMState(poses, lms, lam, trace, st.k + 1, st.cg_total + carry.k)


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
    block, block-Jacobi on the landmarks). `iters` LM iterations (JAX's
    ``fori_loop``), each run by `utils.graphs.solve_loop`: a head, CG in
    blocks of `pcg.BLOCK` masked steps, a tail.
    """
    if precond not in PRECONDITIONERS:
        raise ValueError(f"precond must be one of {PRECONDITIONERS}, got {precond!r}")
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    chain, chain_i = _chain(g) if precond == "chain" else (None, None)
    inputs = (g, _SE2Consts(free_p, free_l, edge_segments(g), chain, chain_i), _Params(huber_delta, precond, cg_iters))
    state = _start(g.poses, linearize_se2(g, huber_delta).chi2, lm_lambda0, iters, g.landmarks)
    solve = graphs.Solve(_se2_head, _se2_tail, _cg_report, cg_loop(_se2_operators, lambda cs: cs[1].tol2, cg_iters))
    st, (cg_total,) = graphs.solve_loop(f"optimize_se2 ({precond})", solve, inputs, state, iters)
    return g.with_poses(st.poses, st.lms), OptStats(st.trace, st.lam, cg_total)


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


class _DirectMid(NamedTuple):
    chi2: torch.Tensor
    new_poses: torch.Tensor
    new_lms: torch.Tensor


def _direct_head(inputs, st: LMState):
    """The dense system, its Cholesky factor, the refined step."""
    g, (free, plan), huber_delta = inputs
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    lin = linearize_se2(g.with_poses(st.poses, st.lms), huber_delta)
    H, b = _dense_system(g, lin, plan)
    # gauge and mask projection: fixed or padded DOFs become identity rows
    Hd = H.mul_(free[:, None] * free[None, :])
    diag = Hd.diagonal()
    diag.add_(st.lam * diag + (1.0 - free) + 1e-6 * free)
    L = torch.linalg.cholesky_ex(Hd, check_errors=False).L
    rhs = (-b * free)[:, None]
    dx = torch.cholesky_solve(rhs, L)
    for _ in range(2):
        dx = dx + torch.cholesky_solve(rhs - Hd @ dx, L)
    dx = dx[:, 0] * free
    new_poses = st.poses + dx[: 3 * NP].reshape(NP, 3)
    new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
    return _DirectMid(lin.chi2, new_poses, st.lms + dx[3 * NP:].reshape(NL, 2)), None


def _direct_tail(inputs, st: LMState, mid: _DirectMid, carry) -> LMState:
    """Accept or reject, Nielsen's lambda schedule, the convergence test."""
    g, _, huber_delta = inputs
    lin_new = linearize_se2(g.with_poses(mid.new_poses, mid.new_lms), huber_delta)
    ok = torch.isfinite(lin_new.chi2) & (lin_new.chi2 < mid.chi2)
    poses = torch.where(ok, mid.new_poses, st.poses)
    lms = torch.where(ok, mid.new_lms, st.lms)
    lam = torch.where(ok, torch.clamp_min(st.lam / 3.0, 1e-12), torch.clamp_max(st.lam * st.nu, 1e10))
    nu = torch.where(ok, 2.0, torch.clamp_max(st.nu * 2.0, 64.0))
    rel_drop = (mid.chi2 - lin_new.chi2) / torch.clamp_min(mid.chi2, 1e-30)
    done = (ok & (rel_drop < 1e-9)) | (~ok & (lam >= 1e10))
    trace = trace_put(st.trace, st.k, torch.where(ok, lin_new.chi2, mid.chi2))
    return LMState(poses, lms, lam, trace, st.k + 1, None, nu, done)


def _direct_report(st: LMState):
    return torch.stack([st.done.to(torch.int64), st.k])


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
    the one host read of an LM iteration is that test (on the card each LM
    iteration replays two graphs, `utils.graphs.solve_loop`). The returned
    stats' `cg_iters` is the number of LM iterations run.
    """
    dtype = g.poses.dtype
    free_p = (g.pose_mask & ~g.fixed).to(dtype)
    free_l = g.landmark_mask.to(dtype)
    free = torch.cat([free_p.repeat_interleave(3), free_l.repeat_interleave(2)])
    state = _start(g.poses, linearize_se2(g, huber_delta).chi2, lm_lambda0, iters, g.landmarks, cg=False, stops=True)
    solve = graphs.Solve(_direct_head, _direct_tail, _direct_report, stops=True)
    st, (_, k) = graphs.solve_loop("optimize_se2_direct", solve, (g, (free, _dense_plan(g)), huber_delta), state,
                                   iters)
    return g.with_poses(st.poses, st.lms), OptStats(st.trace, st.lam, k)


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


def _se3_frames(g: PoseGraph3D):
    """(Ti, Tj, Zinv, zero): each edge's end poses and inverse measurement
    as (EP, 4, 4) matrices, and the zero twist."""
    Ti = _pose7_to_T(g.poses[g.pp_ij[:, 0]])
    Tj = _pose7_to_T(g.poses[g.pp_ij[:, 1]])
    Zinv = lie.se3_inverse(_pose7_to_T(g.pp_meas))
    return Ti, Tj, Zinv, torch.zeros(6, dtype=g.poses.dtype, device=g.poses.device)


def linearize_se3(g: PoseGraph3D, huber_delta=None) -> Linearization:
    Ti, Tj, Zinv, zero = _se3_frames(g)
    e = se3_pp_residual_local(zero, zero, Ti, Tj, Zinv)
    Ji = torch.func.jacfwd(lambda d: se3_pp_residual_local(d, zero, Ti, Tj, Zinv))(zero)
    Jj = torch.func.jacfwd(lambda d: se3_pp_residual_local(zero, d, Ti, Tj, Zinv))(zero)
    w, total = _weigh(e, g.pp_info, g.pp_mask, huber_delta)
    return Linearization(e, Ji, Jj, w, None, None, None, None, total)


class _SE3Consts(NamedTuple):
    free_p: torch.Tensor
    I_seg: ss.SegmentIndex
    J_seg: ss.SegmentIndex
    chain: torch.Tensor | None
    chain_i: ss.SegmentIndex | None


def _se3_head(inputs, st: LMState):
    """Linearize, the gradient and block diagonal, the preconditioner, and
    the whole CG (`ops.se3_pcg.solve`: one kernel launch on the card)."""
    g, c, prm = inputs
    lin = linearize_se3(g.with_poses(st.poses), prm.huber_delta)
    we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
    gp = ss.segment_sum(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), c.I_seg) + ss.segment_sum(
        torch.einsum("kdi,kd->ki", lin.Jj_pp, we), c.J_seg
    )
    Dp = ss.segment_sum(_jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), c.I_seg) + ss.segment_sum(
        _jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp), c.J_seg
    )
    Dp_d = _damped(Dp, st.lam, c.free_p)
    if prm.precond == "chain":
        L_pre, U_pre = _chain_blocks(lin, c.chain, c.chain_i, c.free_p)
        pre = cr_factor(L_pre, Dp_d, U_pre)
    else:
        pre = _inv(Dp_d)
    system = se3_pcg.System(lin.Ji_pp, lin.Jj_pp, lin.w_pp, c.I_seg, c.J_seg, Dp, st.lam, c.free_p, pre)
    return lin.chi2, se3_pcg.solve(system, -gp * c.free_p[:, None], 1e-8, prm.cg_iters)


def _se3_tail(inputs, st: LMState, chi2, carry) -> LMState:
    g, c, prm = inputs
    (dp,) = carry.x
    new_poses = _T_to_pose7(_pose7_to_T(st.poses) @ lie.se3_exp(dp * c.free_p[:, None]))
    chi2_new = chi2_se3(g.with_poses(new_poses), prm.huber_delta)
    accept = chi2_new < chi2
    poses = torch.where(accept, new_poses, st.poses)
    lam = torch.where(accept, torch.clamp_min(st.lam * 0.5, 1e-10), torch.clamp_max(st.lam * 4.0, 1e8))
    trace = trace_put(st.trace, st.k, torch.where(accept, chi2_new, chi2))
    return LMState(poses, None, lam, trace, st.k + 1, st.cg_total + carry.k)


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
    block-tridiagonal odometry-chain factor by cyclic reduction). `iters`
    LM iterations, each run by `utils.graphs.solve_loop` as a head, which
    ends with the whole CG (`ops.se3_pcg.solve`), and a tail.
    """
    if precond not in PRECONDITIONERS:
        raise ValueError(f"precond must be one of {PRECONDITIONERS}, got {precond!r}")
    NP = g.poses.shape[0]
    free_p = (g.pose_mask & ~g.fixed).to(g.poses.dtype)
    chain, chain_i = _chain(g) if precond == "chain" else (None, None)
    consts = _SE3Consts(free_p, ss.SegmentIndex(g.pp_ij[:, 0], NP), ss.SegmentIndex(g.pp_ij[:, 1], NP), chain,
                        chain_i)
    state = _start(g.poses, _CHI2_SE3(g, huber_delta), lm_lambda0, iters)
    st, (cg_total,) = graphs.solve_loop(f"optimize_se3 ({precond})", graphs.Solve(_se3_head, _se3_tail, _cg_report),
                                        (g, consts, _Params(huber_delta, precond, cg_iters)), state, iters)
    return g.with_poses(st.poses), OptStats(st.trace, st.lam, cg_total)


def chi2_se3(g: PoseGraph3D, huber_delta=None) -> torch.Tensor:
    """`linearize_se3(g, huber_delta).chi2`, bit for bit, without the
    Jacobians, whose forward-mode products are most of its operations."""
    Ti, Tj, Zinv, zero = _se3_frames(g)
    return _weigh(se3_pp_residual_local(zero, zero, Ti, Tj, Zinv), g.pp_info, g.pp_mask, huber_delta)[1]


# the start of `optimize_se3`: one graph replay in place of its ~400 eager launches
_CHI2_SE3 = graphs.Stage("chi2_se3", chi2_se3, second_call=True)
