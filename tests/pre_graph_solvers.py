"""The backend's LM loops as they were before they ran through
``utils/graphs.solve_loop``: verbatim copies of the eager loops (PCG's
stopping test and the convergence tests read on the host), which
``tests/test_torch_solver_graphs.py`` (the 2D and 3D pose graphs) and
``tests/test_torch_landmark_graphs.py`` (line SLAM, the plane graph, BA)
hold the port's solvers to bit for bit, and ``tests/test_torch_parallel_graphs.py``
the distributed solvers. The helpers they call are the
port's own, but for `landmark_edge_segments`, the landmark loops' edge
sort as it was then (every edge into its own row, padding included)."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import torch

from g2o_frontend_tpu_torch.graph.store import PoseGraph2D, PoseGraph3D
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.solvers import ba as tba
from g2o_frontend_tpu_torch.solvers import line_slam as tls
from g2o_frontend_tpu_torch.solvers import plane_slam as tps
from g2o_frontend_tpu_torch.solvers import pose_graph as pg
from g2o_frontend_tpu_torch.solvers.pose_graph import (PRECONDITIONERS, OptStats, _block_jacobi_precond, _chain,
                                                       _chain_blocks, _compose_hvp, _damped, _damped_inverse,
                                                       _dense_plan, _dense_system, _diag_blocks_se2, _grad_se2,
                                                       _hvp_edges_se2, _inv, _jtwj, _pose7_to_T, _T_to_pose7,
                                                       edge_segments, linearize_se2, linearize_se3)
from g2o_frontend_tpu_torch.solvers.schur_pcg import (WOODBURY_MAX_DIM, SchurStats, _arrow_index, _block_diag,
                                                      _damped_blocks, _landmark_arrow)
from g2o_frontend_tpu_torch.solvers.tridiag import cr_factor, cr_solve
from g2o_frontend_tpu_torch.parallel import partitioned_pose_graph as ppg
from g2o_frontend_tpu_torch.parallel.mesh import offset_pairs, shard_rows, tile
from g2o_frontend_tpu_torch.parallel.partitioned_pose_graph import (PRECONDITIONERS_SE2, PRECONDITIONERS_SE3, _bmv,
                                                                    _Shards, _Shards2D, comm_volume, partition_se2,
                                                                    partition_se3, partition_stats)
from g2o_frontend_tpu_torch.parallel.partitioned_schur import MAX_LANDMARKS, _damped_or_eye
from g2o_frontend_tpu_torch.parallel.sharded_pose_graph import shard_chi2
from g2o_frontend_tpu_torch.parallel.spike import spike_factor, spike_solve, spike_solve_bytes
from g2o_frontend_tpu_torch.solvers.ba import BAProblem, _linearize
from g2o_frontend_tpu_torch.utils import lie


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _axpy(alpha, x, y):
    """alpha * x + y"""
    return tuple(alpha * xl + yl for xl, yl in zip(x, y))


def pcg(hvp: Callable, b, precond: Callable, *, max_iters: int = 100, rtol: float = 1e-6,
        tree_dot: Callable | None = None):
    """Solve ``H x = b`` with preconditioned CG.

    Args:
      hvp: function v -> H @ v on the block vector (a tuple of tensors).
      b: right-hand side, a tuple of tensors.
      precond: function r -> M^{-1} r (e.g. block-Jacobi).
      max_iters: the most iterations.
      rtol: relative residual tolerance on sqrt(r.z).
      tree_dot: optional replacement inner product, returning a 0-dim
        tensor: a distributed solver passes a dot that sums over the shards
        of its block vectors (`parallel/partitioned_pose_graph.py`), so
        that every shard reads the same stopping test.

    Returns:
      (x, iters, final_rz): iters is a Python int, final_rz a 0-dim tensor.
    """
    if tree_dot is None:
        tree_dot = _dot
    x = tuple(torch.zeros_like(bl) for bl in b)
    r = tuple(b)  # r = b - H x0 with x0 = 0
    z = precond(r)
    p = z
    rz = tree_dot(r, z)
    tol2 = rtol * rtol * torch.clamp_min(rz, 1e-30)
    k = 0
    while k < max_iters and bool(rz > tol2):
        hp = hvp(p)
        php = tree_dot(p, hp)
        # guard against a non-PD direction (should not happen with LM damping)
        alpha = torch.where(php > 0, rz / torch.where(php > 0, php, 1e-30), 0.0)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, hp, r)
        z = precond(r)
        rz_new = tree_dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, 1e-30)
        p = _axpy(beta, p, z)
        rz = rz_new
        k += 1
    return x, k, rz


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
    seg = consts["seg"]
    use_woodbury = consts["use_woodbury"]

    gp, gl = pg._grad_se2(gk, lin, seg)
    Dp, Dl = pg._diag_blocks_se2(gk, lin, seg)
    bp = -gp * free_p[:, None]

    if has_pl:
        # per-edge cross block Jp^T W Jl (3x2) and the landmark-block inverse
        C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)
        Hll_inv = pg._inv(_damped_blocks(Dl, lam, free_l, 2))
        ybl = torch.einsum("lij,lj->li", Hll_inv, -gl * free_l[:, None])
        bs = bp - free_p[:, None] * ss.segment_sum(torch.einsum("kij,kj->ki", C, ybl[lm_k]), seg.pl_p)
        # per-pose Schur diagonal correction (exact when each (pose,
        # landmark) pair has one observation edge, as in g2o graphs)
        corr = None if use_woodbury else ss.segment_sum(
            torch.einsum("kij,kjl,kml->kim", C, Hll_inv[lm_k], C), seg.pl_p)
    else:
        bs, corr = bp, torch.zeros_like(Dp)

    edge_hvp = pg._hvp_edges_se2(gk, lin, seg)
    zeros_l = gk.poses.new_zeros((NL, 2))
    diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)

    def smv(v):
        vp = v[0] * free_p[:, None]
        # the pose slot of the edge product with vl = 0 is Hpp v
        hp, _ = edge_hvp((vp, zeros_l))
        hp = hp + lam * diagDp * vp
        if has_pl:
            t = ss.segment_sum(torch.einsum("kji,kj->ki", C, vp[pose_k]), seg.pl_l)
            y = torch.einsum("lij,lj->li", Hll_inv, t)
            hp = hp - ss.segment_sum(torch.einsum("kij,kj->ki", C, y[lm_k]), seg.pl_p)
        return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

    # T: the damped odometry chain, factored by cyclic reduction once per LM
    # iteration
    L_pre, U_pre = pg._chain_blocks(lin, consts["chain"], consts["chain_i"], free_p)
    if use_woodbury:
        # M = T - V A^-1 V^T, the chain with the FULL landmark arrow: exactly S
        # when Hpp has no off-chain blocks. M^-1 = T^-1 + T^-1 V K^-1 V^T T^-1
        # with K = A - V^T T^-1 V (2 NL x 2 NL, dense: landmarks are few)
        fac = cr_factor(L_pre, _damped_blocks(Dp, lam, free_p, 3), U_pre)
        Vd = _landmark_arrow(C, consts["arrow"], free_p, NP, NL)
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
        t = ss.segment_sum(torch.einsum("kji,kj->ki", C, dp[pose_k]), seg.pl_l)
        return (ybl - torch.einsum("lij,lj->li", Hll_inv, t)) * free_l[:, None]

    return smv, precond, bs, recover_dl


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
    pose_k, lm_k = (g.pl_ij[:, 0], g.pl_ij[:, 1]) if has_pl else (None, None)
    consts = dict(NP=NP, NL=NL, free_p=free_p, free_l=free_l, has_pl=has_pl, pose_k=pose_k, lm_k=lm_k,
                  seg=pg.edge_segments(g), arrow=_arrow_index(pose_k, lm_k, NP, NL) if use_woodbury else None,
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


# -- the landmark graphs' loops (line SLAM, the plane graph, BA) --------------------------


def landmark_edge_segments(g) -> pg.EdgeSegments:
    """`EdgeSegments` of a graph (or any namespace with poses, landmarks,
    pp_ij and pl_ij)."""
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    return pg.EdgeSegments(ss.SegmentIndex(g.pp_ij[:, 0], NP), ss.SegmentIndex(g.pp_ij[:, 1], NP),
                           ss.SegmentIndex(g.pl_ij[:, 0], NP), ss.SegmentIndex(g.pl_ij[:, 1], NL))


def lm_with_landmarks(poses, lms, pp_ij, pl_ij, free_p, free_l, linearize, retract, iters, cg_iters, lm_lambda0):
    """The LM loop of a pose graph with landmarks (lines, planes): block-
    Jacobi PCG on the pose and landmark blocks, LM damping on the diagonal
    blocks, accept or reject on the device.

    linearize(poses, lms, jacobians) -> `pose_graph.Linearization`;
    retract(poses, lms, dp, dl) -> the updated (poses, lms). Returns (poses,
    lms, chi2 trace (iters+1,))."""
    layout = SimpleNamespace(poses=poses, landmarks=lms, pp_ij=pp_ij, pl_ij=pl_ij)
    seg = landmark_edge_segments(layout)  # the edge ends sorted once, for every sum of the solve
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


def optimize_line_graph(g: tls.LineGraph, iters: int = 10, cg_iters: int = 60, lm_lambda0: float = 1e-4):
    """LM over poses and line landmarks; returns (graph, chi2 trace (iters+1,))."""

    def linearize(poses, lines, jacobians):
        return tls._linearize(g._replace(poses=poses, lines=lines), jacobians)

    def retract(poses, lines, dp, dl):
        return tls._wrap_col(poses + dp, 2), tls._wrap_col(lines + dl, 0)

    poses, lines, trace = lm_with_landmarks(
        g.poses, g.lines, g.pp_ij, g.pl_ij, (g.pose_mask & ~g.fixed).to(g.poses.dtype), g.line_mask.to(g.poses.dtype),
        linearize, retract, iters, cg_iters, lm_lambda0)
    return g._replace(poses=poses, lines=lines), trace


def optimize_plane_graph(g: tps.PlaneGraph, iters: int = 10, cg_iters: int = 60, lm_lambda0: float = 1e-4):
    """LM over poses + plane landmarks; returns (graph, chi2 trace (iters+1,))."""

    def linearize(poses, planes, jacobians):
        return tps._linearize(g._replace(poses=poses, planes=planes), jacobians)

    def retract(poses, planes, dp, dl):
        return _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dp)), tps._apply_plane_update(planes, dl)

    poses, planes, trace = lm_with_landmarks(
        g.poses, g.planes, g.pp_ij, g.pl_ij, (g.pose_mask & ~g.fixed).to(g.poses.dtype),
        g.plane_mask.to(g.poses.dtype), linearize, retract, iters, cg_iters, lm_lambda0)
    return g._replace(poses=poses, planes=planes), trace


def optimize_ba(ba: tba.BAProblem, iters: int = 10, cg_iters: int = 50, lm_lambda0: float = 1e-4):
    """LM-BA with matrix-free Schur-reduced camera solves; returns (problem,
    chi2 trace (iters+1,))."""
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    dtype, dev = ba.poses.dtype, ba.poses.device
    free_c = (ba.pose_mask & ~ba.fixed).to(dtype)
    free_p = ba.point_mask.to(dtype)
    ci, pi = ba.obs_ij[:, 0], ba.obs_ij[:, 1]
    ci_seg, pi_seg = ss.SegmentIndex(ci, NP), ss.SegmentIndex(pi, NL)
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)

    def chi2_of(poses, points):
        return tba._linearize(ba._replace(poses=poses, points=points), False)[4]

    poses, points = ba.poses, ba.points
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    trace = [chi2_of(poses, points)]
    for _ in range(iters):
        e, Jc, Jp, w, chi2 = tba._linearize(ba._replace(poses=poses, points=points))

        we = torch.einsum("kij,kj->ki", w, e)
        g_c = ss.segment_sum(torch.einsum("kdi,kd->ki", Jc, we), ci_seg)
        g_p = ss.segment_sum(torch.einsum("kdi,kd->ki", Jp, we), pi_seg)
        D_c = ss.segment_sum(_jtwj(Jc, w, Jc), ci_seg)
        H_pp = ss.segment_sum(_jtwj(Jp, w, Jp), pi_seg)
        H_pp_d = H_pp + (lam * H_pp * eye3 + 1e-6 * eye3)
        H_pp_inv = _inv(torch.where(free_p[:, None, None] > 0, H_pp_d, eye3))

        def Hcp_apply(vp, Jc=Jc, Jp=Jp, w=w):  # (NL, 3) -> (NP, 6): sum_obs Jc^T W Jp vp
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jp, vp[pi]))
            return ss.segment_sum(torch.einsum("kdi,kd->ki", Jc, WJv), ci_seg)

        def Hpc_apply(vc, Jc=Jc, Jp=Jp, w=w):  # (NP, 6) -> (NL, 3)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, vc[ci]))
            return ss.segment_sum(torch.einsum("kdi,kd->ki", Jp, WJv), pi_seg)

        # Schur right-hand side: b_s = -g_c + H_cp H_pp^-1 g_p
        b_s = (-g_c + Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * free_c[:, None]
        lam_D = lam * D_c * eye6

        def schur_hvp(v, Jc=Jc, w=w, lam_D=lam_D, H_pp_inv=H_pp_inv, Hcp_apply=Hcp_apply, Hpc_apply=Hpc_apply):
            vc = v[0] * free_c[:, None]
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, vc[ci]))
            hcc = ss.segment_sum(torch.einsum("kdi,kd->ki", Jc, WJv), ci_seg) + torch.einsum("kij,kj->ki", lam_D, vc)
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

# -- the distributed solvers (parallel/) as they were before their LM loops ran through solve_loop --------------
# Verbatim but for `ppg.` before the partitioned module's `_damped_inverse`, whose name the single-device one
# above takes.

def optimize_se2_sharded(g: PoseGraph2D, mesh, iters: int = 10, cg_iters: int = 100, lm_lambda0: float = 1e-4):
    """LM-optimize with edges sharded over `mesh`; returns (graph, chi2 trace)."""
    dev, dtype = mesh.device, g.poses.dtype
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    pp = [shard_rows(getattr(g, f), mesh) for f in ("pp_ij", "pp_meas", "pp_info", "pp_mask")]
    pl = [shard_rows(getattr(g, f), mesh) for f in ("pl_ij", "pl_meas", "pl_info", "pl_mask")]
    S = pp[0].shape[0]
    flat = PoseGraph2D(
        poses=tile(g.poses.to(dev), S), pose_mask=tile(g.pose_mask.to(dev), S),
        landmarks=tile(g.landmarks.to(dev), S), landmark_mask=tile(g.landmark_mask.to(dev), S),
        pp_ij=offset_pairs(pp[0], NP, NP, mesh=mesh), pp_meas=pp[1].flatten(0, 1), pp_info=pp[2].flatten(0, 1),
        pp_mask=pp[3].flatten(0, 1), pl_ij=offset_pairs(pl[0], NP, NL, mesh=mesh), pl_meas=pl[1].flatten(0, 1),
        pl_info=pl[2].flatten(0, 1), pl_mask=pl[3].flatten(0, 1), fixed=tile(g.fixed.to(dev), S))
    free_p = (g.pose_mask & ~g.fixed).to(device=dev, dtype=dtype)
    free_l = g.landmark_mask.to(device=dev, dtype=dtype)

    def psum_rows(x, n):
        return mesh.psum(x.view((S, n) + x.shape[1:]))[0]

    def linearize(poses, lms):
        gk = flat.with_poses(tile(poses, S), tile(lms, S))
        lin = pg.linearize_se2(gk)
        chi2 = shard_chi2(lin.e_pp, lin.w_pp, S)
        if lin.e_pl is not None:
            chi2 = chi2 + shard_chi2(lin.e_pl, lin.w_pl, S)
        return gk, lin, mesh.psum(chi2)[0]

    seg = pg.edge_segments(flat)  # the edge ends sorted once, for every sum of the solve
    poses, lms = g.poses.to(dev), g.landmarks.to(dev)
    trace = [linearize(poses, lms)[2]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        gk, lin, chi2 = linearize(poses, lms)
        gp, gl = pg._grad_se2(gk, lin, seg)
        Dp, Dl = pg._diag_blocks_se2(gk, lin, seg)
        gp, gl, Dp, Dl = psum_rows(gp, NP), psum_rows(gl, NL), psum_rows(Dp, NP), psum_rows(Dl, NL)
        edge_hvp = pg._hvp_edges_se2(gk, lin, seg)

        def sharded_edge_hvp(v, edge_hvp=edge_hvp):
            hp, hl = edge_hvp((tile(v[0], S), tile(v[1], S)))
            return psum_rows(hp, NP), psum_rows(hl, NL)

        hvp = pg._compose_hvp(sharded_edge_hvp, free_p, free_l, lam, Dp, Dl)
        pre = pg._block_jacobi_precond(Dp, Dl, free_p, free_l, lam)
        (dp, dl), _, _ = pcg(hvp, (-gp * free_p[:, None], -gl * free_l[:, None]), pre, max_iters=cg_iters, rtol=1e-8)
        new_poses = poses + dp * free_p[:, None]
        new_poses = torch.cat([new_poses[:, :2], lie.wrap_angle(new_poses[:, 2:])], 1)
        new_lms = lms + dl * free_l[:, None]
        new_chi2 = linearize(new_poses, new_lms)[2]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(poses.to(g.poses.device), lms.to(g.poses.device)), torch.stack(trace)


def optimize_se3_sharded(g: PoseGraph3D, mesh, iters: int = 10, cg_iters: int = 100, lm_lambda0: float = 1e-4):
    """LM-optimize with edges sharded over `mesh`; returns (graph, chi2 trace)."""
    dev, dtype = mesh.device, g.poses.dtype
    NP = g.poses.shape[0]
    ij, meas, info, mask = (shard_rows(getattr(g, f), mesh) for f in ("pp_ij", "pp_meas", "pp_info", "pp_mask"))
    S = ij.shape[0]
    flat = PoseGraph3D(tile(g.poses.to(dev), S), tile(g.pose_mask.to(dev), S), offset_pairs(ij, NP, NP, mesh=mesh),
                       meas.flatten(0, 1), info.flatten(0, 1), mask.flatten(0, 1), tile(g.fixed.to(dev), S))
    I, J = flat.pp_ij[:, 0], flat.pp_ij[:, 1]
    I_seg, J_seg = ss.SegmentIndex(I, S * NP), ss.SegmentIndex(J, S * NP)
    free_p = (g.pose_mask & ~g.fixed).to(device=dev, dtype=dtype)

    def psum_rows(x):
        return mesh.psum(x.view((S, NP) + x.shape[1:]))[0]

    def scatter(a, b):
        """Each shard's sum of per-edge terms at both endpoints, psum'd."""
        return psum_rows(ss.segment_sum(a, I_seg) + ss.segment_sum(b, J_seg))

    def linearize(poses):
        lin = pg.linearize_se3(flat.with_poses(tile(poses, S)))
        return lin, mesh.psum(shard_chi2(lin.e_pp, lin.w_pp, S))[0]

    poses = g.poses.to(dev)
    trace = [linearize(poses)[1]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        lin, chi2 = linearize(poses)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = scatter(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), torch.einsum("kdi,kd->ki", lin.Jj_pp, we))
        Dp = scatter(pg._jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), pg._jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp))

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            vp = tile(v[0] * free_p[:, None], S)
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, vp[I]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, vp[J])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = scatter(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv))
            hp = hp + lam * torch.einsum("kij,kj->ki", Dp, v[0] * free_p[:, None])
            return (hp * free_p[:, None] + (1.0 - free_p)[:, None] * v[0],)

        Dp_inv = pg._damped_inverse(Dp, lam, free_p)

        def pre(r, Dp_inv=Dp_inv):
            return (torch.einsum("kij,kj->ki", Dp_inv, r[0]),)

        (dp,), _, _ = pcg(hvp, (-gp * free_p[:, None],), pre, max_iters=cg_iters, rtol=1e-8)
        new_poses = pg._T_to_pose7(pg._pose7_to_T(poses) @ lie.se3_exp(dp * free_p[:, None]))
        new_chi2 = linearize(new_poses)[1]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(poses.to(g.poses.device)), torch.stack(trace)


def optimize_ba_sharded(ba: BAProblem, mesh, iters: int = 10, cg_iters: int = 50, lm_lambda0: float = 1e-4):
    """Observation-sharded LM-BA; returns (problem, chi2 trace)."""
    dev, dtype = mesh.device, ba.poses.dtype
    NP, NL = ba.poses.shape[0], ba.points.shape[0]
    ij, z, info, mask = (shard_rows(getattr(ba, f), mesh) for f in ("obs_ij", "obs_z", "obs_info", "obs_mask"))
    S = ij.shape[0]
    flat = BAProblem(tile(ba.poses.to(dev), S), tile(ba.pose_mask.to(dev), S), tile(ba.points.to(dev), S),
                     tile(ba.point_mask.to(dev), S), offset_pairs(ij, NP, NL, mesh=mesh), z.flatten(0, 1),
                     info.flatten(0, 1), mask.flatten(0, 1), tile(ba.fixed.to(dev), S))
    ci, pi = flat.obs_ij[:, 0], flat.obs_ij[:, 1]
    ci_seg, pi_seg = ss.SegmentIndex(ci, S * NP), ss.SegmentIndex(pi, S * NL)  # sorted once a solve
    free_c = (ba.pose_mask & ~ba.fixed).to(device=dev, dtype=dtype)
    free_p = ba.point_mask.to(device=dev, dtype=dtype)
    eye3, eye6 = torch.eye(3, dtype=dtype, device=dev), torch.eye(6, dtype=dtype, device=dev)

    def psum_seg(x, seg, n):
        """Each shard's segment sum into n rows, psum'd."""
        return mesh.psum(ss.segment_sum(x, seg).view((S, n) + x.shape[1:]))[0]

    def local_lin(poses, points, jacobians=True):
        e, Jc, Jp, w, _ = _linearize(flat._replace(poses=tile(poses, S), points=tile(points, S)), jacobians)
        return e, Jc, Jp, w, mesh.psum(shard_chi2(e, w, S))[0]

    poses, points = ba.poses.to(dev), ba.points.to(dev)
    trace = [local_lin(poses, points, False)[4]]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    for _ in range(iters):
        e, Jc, Jp, w, chi2 = local_lin(poses, points)
        we = torch.einsum("kij,kj->ki", w, e)
        g_c = psum_seg(torch.einsum("kdi,kd->ki", Jc, we), ci_seg, NP)
        g_p = psum_seg(torch.einsum("kdi,kd->ki", Jp, we), pi_seg, NL)
        D_c = psum_seg(_jtwj(Jc, w, Jc), ci_seg, NP)
        H_pp = psum_seg(_jtwj(Jp, w, Jp), pi_seg, NL)
        H_pp_inv = _inv(torch.where(free_p[:, None, None] > 0, H_pp + (lam * H_pp * eye3 + 1e-6 * eye3), eye3))

        def Hcp_apply(vp, Jc=Jc, Jp=Jp, w=w):  # (NL, 3) -> (NP, 6)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jp, tile(vp, S)[pi]))
            return psum_seg(torch.einsum("kdi,kd->ki", Jc, WJv), ci_seg, NP)

        def Hpc_apply(vc, Jc=Jc, Jp=Jp, w=w):  # (NP, 6) -> (NL, 3)
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, tile(vc, S)[ci]))
            return psum_seg(torch.einsum("kdi,kd->ki", Jp, WJv), pi_seg, NL)

        b_s = (-g_c + Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, g_p))) * free_c[:, None]
        lam_D = lam * D_c * eye6

        def schur_hvp(v, Jc=Jc, w=w, lam_D=lam_D, H_pp_inv=H_pp_inv, Hcp_apply=Hcp_apply, Hpc_apply=Hpc_apply):
            vc = v[0] * free_c[:, None]
            WJv = torch.einsum("kde,ke->kd", w, torch.einsum("kdi,ki->kd", Jc, tile(vc, S)[ci]))
            hcc = psum_seg(torch.einsum("kdi,kd->ki", Jc, WJv), ci_seg, NP) + torch.einsum("kij,kj->ki", lam_D, vc)
            out = hcc - Hcp_apply(torch.einsum("kij,kj->ki", H_pp_inv, Hpc_apply(vc)))
            return (out * free_c[:, None] + (1.0 - free_c)[:, None] * v[0],)

        D_inv = _inv(torch.where(free_c[:, None, None] > 0, D_c + lam_D + 1e-6 * eye6, eye6))

        def precond(r, D_inv=D_inv):
            return (torch.einsum("kij,kj->ki", D_inv, r[0]),)

        (dc,), _, _ = pcg(schur_hvp, (b_s,), precond, max_iters=cg_iters, rtol=1e-8)
        dc = dc * free_c[:, None]
        dp = torch.einsum("kij,kj->ki", H_pp_inv, -g_p - Hpc_apply(dc)) * free_p[:, None]
        new_poses = _T_to_pose7(_pose7_to_T(poses) @ lie.se3_exp(dc))
        new_points = points + dp
        new_chi2 = local_lin(new_poses, new_points, False)[4]
        accept = new_chi2 < chi2
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return ba._replace(poses=poses.to(ba.poses.device), points=points.to(ba.poses.device)), torch.stack(trace)


def optimize_se2_partitioned(
    g: PoseGraph2D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    halo_mode: str = "auto",
    precond: str = "jacobi",
):
    """LM over a pose-block partition; returns (graph, chi2_trace, stats).

    Convergence matches `optimize_se2` up to reduction order; state, edges,
    diagonal blocks and CG vectors are sharded.

    precond: "jacobi" (trajectory-identical to the single-device solver) or
    "chain": each shard cyclic-reduction-factors ITS OWN block's
    odometry-chain tridiagonal with no extra communication; boundary chain
    edges stay unpreconditioned.
    """
    if precond not in PRECONDITIONERS_SE2:
        raise ValueError(f"precond must be one of {PRECONDITIONERS_SE2}, got {precond!r}")
    part = partition_se2(g, mesh.size, halo_mode=halo_mode)
    sh = _Shards2D(part, mesh)
    free_p, free_l = sh.free_p[..., None], sh.free_l[..., None]

    def chi2_of(pb, lb):
        return sh.chi2(pg.linearize_se2(sh.graph(pb, lb)))

    seg = pg.edge_segments(sh.graph0)
    pb, lb = sh.poses0, sh.lms0
    trace = [chi2_of(pb, lb)]
    lam = torch.tensor(lm_lambda0, dtype=pb.dtype, device=pb.device)
    cg_total = 0
    for _ in range(iters):
        gk = sh.graph(pb, lb)
        lin = pg.linearize_se2(gk)
        chi2 = sh.chi2(lin)
        gp, gl = sh.reduce(*pg._grad_se2(gk, lin, seg))
        Dp, Dl = sh.reduce(*pg._diag_blocks_se2(gk, lin, seg))
        edge_hvp = pg._hvp_edges_se2(gk, lin, seg)

        def hvp(v, edge_hvp=edge_hvp, Dp=Dp, Dl=Dl, lam=lam):
            vp, vl = v[0] * free_p, v[1] * free_l
            hp, hl = sh.reduce(*edge_hvp((sh.halo.gather_aug(vp).flatten(0, 1),
                                          sh.halo_l.gather_aug(vl).flatten(0, 1))))
            hp = hp + lam * _bmv(Dp, vp)
            hl = hl + lam * _bmv(Dl, vl)
            return hp * free_p + (1.0 - free_p) * v[0], hl * free_l + (1.0 - free_l) * v[1]

        Dl_inv = ppg._damped_inverse(Dl, lam, sh.free_l)
        if precond == "chain":
            # per-shard block-local chain tridiagonal: factored with cyclic
            # reduction, applied shard-locally, no communication
            L_pre, U_pre = sh.chain_blocks(lin)
            Dp_d = pg._damped(Dp.flatten(0, 1), lam, sh.free_p.flatten()).view(Dp.shape)
            fac = cr_factor(L_pre, Dp_d, U_pre)

            def pre(r, fac=fac, Dl_inv=Dl_inv):
                return cr_solve(fac, r[0]), _bmv(Dl_inv, r[1])
        else:
            Dp_inv = ppg._damped_inverse(Dp, lam, sh.free_p)

            def pre(r, Dp_inv=Dp_inv, Dl_inv=Dl_inv):
                return _bmv(Dp_inv, r[0]), _bmv(Dl_inv, r[1])

        (dp, dl), cg_k, _ = pcg(hvp, (-gp * free_p, -gl * free_l), pre, max_iters=cg_iters, rtol=1e-8,
                                tree_dot=sh.dot)
        new_pb = pb + dp * free_p
        new_pb = torch.cat([new_pb[..., :2], lie.wrap_angle(new_pb[..., 2:])], -1)
        new_lb = lb + dl * free_l
        new_chi2 = chi2_of(new_pb, new_lb)
        accept = new_chi2 < chi2
        pb = torch.where(accept, new_pb, pb)
        lb = torch.where(accept, new_lb, lb)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
        cg_total += cg_k
    g_out = g.with_poses(sh.blocks_of(pb, g.poses), sh.lms_of(lb, g.landmarks))
    stats = {"partition": partition_stats(part), "comm": comm_volume(part, iters, cg_total), "cg_total": cg_total}
    return g_out, torch.stack(trace), stats


def optimize_se3_partitioned(
    g: PoseGraph3D,
    mesh,
    iters: int = 10,
    cg_iters: int = 100,
    lm_lambda0: float = 1e-4,
    precond: str = "jacobi",
):
    """SE3 twin of `optimize_se2_partitioned`: pose blocks + ghost halos;
    returns (graph, chi2_trace).

    precond: "jacobi" (block-diagonal) or "spike": each shard
    cyclic-reduction-factors its local 6x6 block tridiagonal and the
    boundary couplings form the replicated SPIKE interface system
    (`spike.py`), the distributed form of the single-device chain
    preconditioner.
    """
    if precond not in PRECONDITIONERS_SE3:
        raise ValueError(f"precond must be one of {PRECONDITIONERS_SE3}, got {precond!r}")
    part = partition_se3(g, mesh.size)
    sh = _Shards(part, mesh, free_next=True)
    loc, S, B, P = mesh.local, sh.S, sh.B, sh.B + sh.G
    dev = sh.poses0.device
    graph0 = PoseGraph3D(sh.poses0.new_zeros((S * P, 7)), torch.ones(S * P, dtype=torch.bool, device=dev),
                         offset_pairs(sh.pp_ij, P, P, mesh=mesh), loc(part.pp_meas).flatten(0, 1),
                         loc(part.pp_info).flatten(0, 1), loc(part.pp_mask).flatten(0, 1),
                         torch.zeros(S * P, dtype=torch.bool, device=dev))
    I, J = sh.pp_ij[..., 0], sh.pp_ij[..., 1]
    I_flat, J_flat = graph0.pp_ij[:, 0], graph0.pp_ij[:, 1]
    I_seg, J_seg = sh.segments(I, P), sh.segments(J, P)
    free_p = sh.free_p[..., None]

    def linearize(pb):
        return pg.linearize_se3(graph0.with_poses(sh.halo.gather_aug(pb).flatten(0, 1)))

    def reduce(a, b):
        """Per-edge terms at both endpoints -> own (S, B, ...) blocks."""
        return sh.halo.reduce(sh.segment_sum(a, I_seg) + sh.segment_sum(b, J_seg))

    pb = sh.poses0
    trace = [sh.chi2(linearize(pb))]
    lam = torch.tensor(lm_lambda0, dtype=pb.dtype, device=dev)
    for _ in range(iters):
        lin = linearize(pb)
        chi2 = sh.chi2(lin)
        we = torch.einsum("kij,kj->ki", lin.w_pp, lin.e_pp)
        gp = reduce(torch.einsum("kdi,kd->ki", lin.Ji_pp, we), torch.einsum("kdi,kd->ki", lin.Jj_pp, we))
        Dp = reduce(pg._jtwj(lin.Ji_pp, lin.w_pp, lin.Ji_pp), pg._jtwj(lin.Jj_pp, lin.w_pp, lin.Jj_pp))

        def hvp(v, lin=lin, Dp=Dp, lam=lam):
            vp = v[0] * free_p
            va = sh.halo.gather_aug(vp).flatten(0, 1)
            Jv = torch.einsum("kdi,ki->kd", lin.Ji_pp, va[I_flat]) + torch.einsum("kdi,ki->kd", lin.Jj_pp, va[J_flat])
            WJv = torch.einsum("kde,ke->kd", lin.w_pp, Jv)
            hp = reduce(torch.einsum("kdi,kd->ki", lin.Ji_pp, WJv), torch.einsum("kdi,kd->ki", lin.Jj_pp, WJv))
            hp = hp + lam * _bmv(Dp, vp)
            return (hp * free_p + (1.0 - free_p) * v[0],)

        Dp_d = pg._damped(Dp.flatten(0, 1), lam, sh.free_p.flatten()).view(Dp.shape)
        if precond == "spike":
            L_pre, U_pre = sh.chain_blocks(lin)
            sf = spike_factor(L_pre, Dp_d, U_pre, sh.boundary_block(lin), mesh)

            def pre(r, sf=sf):
                return (spike_solve(sf, r[0], mesh),)
        else:
            Dp_inv = pg._inv(Dp_d)

            def pre(r, Dp_inv=Dp_inv):
                return (_bmv(Dp_inv, r[0]),)

        (dp,), _, _ = pcg(hvp, (-gp * free_p,), pre, max_iters=cg_iters, rtol=1e-8, tree_dot=sh.dot)
        new_pb = pg._T_to_pose7(pg._pose7_to_T(pb) @ lie.se3_exp(dp * free_p))
        new_chi2 = sh.chi2(linearize(new_pb))
        accept = new_chi2 < chi2
        pb = torch.where(accept, new_pb, pb)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-10), torch.clamp_max(lam * 4.0, 1e8))
        trace.append(torch.where(accept, new_chi2, chi2))
    return g.with_poses(sh.blocks_of(pb, g.poses)), torch.stack(trace)


def optimize_se2_schur_partitioned(
    g: PoseGraph2D,
    mesh,
    iters: int = 100,
    cg_iters: int = 50,
    lm_lambda0: float = 1e-6,
    huber_delta: float | None = None,
    tol: float = 1e-9,
    cg_rtol: float = 1e-6,
    halo_mode: str = "auto",
):
    """LM to convergence on the landmark-eliminated system, fully sharded.

    Returns (graph, chi2_trace, stats). chi2_trace[-1] is the converged
    value; stats carries partition and communication accounting, the
    extra replicated psum floats this solver adds over the block-Jacobi
    one, and the LM iterations run.
    """
    NL = int(g.landmarks.shape[0])
    if NL > MAX_LANDMARKS:
        raise ValueError(f"optimize_se2_schur_partitioned replicates a ({2 * NL})^2 Woodbury arrow; NL > "
                         f"{MAX_LANDMARKS} is out of its regime — use parallel.partitioned_pose_graph (block-Jacobi)")
    n_dev = mesh.size
    part = partition_se2(g, n_dev, halo_mode=halo_mode)
    sh = _Shards2D(part, mesh, free_next=True)
    S, B, BL, GL = sh.S, sh.B, sh.BL, sh.GL
    has_pl = NL > 0
    dev, dtype = sh.poses0.device, sh.poses0.dtype
    free_p, free_l = sh.free_p[..., None], sh.free_l[..., None]
    # replicated landmark validity (identity rows of the global arrow A)
    lm_free = g.landmark_mask.to(device=dev, dtype=dtype)
    pose_k = sh.pl_ij[..., 0]  # always own slots (< B) by construction
    lm_k = sh.pl_ij[..., 1]  # own or ghost landmark slots
    gid_k = torch.gather(sh.lm_gid, 1, lm_k)  # global landmark column ids
    # the same as rows of the flattened (S * B) and (S * (BL + GL)) blocks
    pose_k_flat, lm_k_flat = mesh.flat_index(pose_k, B), mesh.flat_index(lm_k, BL + GL)
    # every sum's index sorted once a solve
    seg = pg.edge_segments(sh.graph0)
    pose_seg, lm_seg = sh.segments(pose_k, B), sh.segments(lm_k, BL + GL)
    arrow_seg, owner_seg = sh.segments(pose_k * NL + gid_k, B * NL), sh.segments(sh.lm_gid[:, :BL], NL)

    def chi2_of(pb, lb):
        return sh.chi2(pg.linearize_se2(sh.graph(pb, lb), huber_delta))

    def build_system(gk, lin, lam):
        """The distributed `schur_pcg.build_schur_system`."""
        gp, gl = sh.reduce(*pg._grad_se2(gk, lin, seg))
        Dp, Dl = sh.reduce(*pg._diag_blocks_se2(gk, lin, seg))
        bp = -gp * free_p
        edge_hvp = pg._hvp_edges_se2(gk, lin, seg)
        diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)
        zeros_l = gk.landmarks.new_zeros(gk.landmarks.shape)
        if has_pl:
            C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)  # (S * EL, 3, 2)
            Hll_inv = pg._inv(_damped_or_eye(Dl, lam, sh.free_l, 2))
            ybl = _bmv(Hll_inv, -gl * free_l)
            ybl_aug = sh.halo_l.gather_aug(ybl).flatten(0, 1)
            bs = bp - free_p * sh.segment_sum(torch.einsum("kij,kj->ki", C, ybl_aug[lm_k_flat]), pose_seg)

        def to_landmarks(vp):
            """Own landmark blocks of sum_k C_k^T vp[pose_k]."""
            t = sh.segment_sum(torch.einsum("kji,kj->ki", C, vp.flatten(0, 1)[pose_k_flat]), lm_seg)
            return sh.halo_l.reduce(t)

        def smv(v):
            vp = v[0] * free_p
            hp_aug, _ = edge_hvp((sh.halo.gather_aug(vp).flatten(0, 1), zeros_l))
            hp = sh.halo.reduce(hp_aug.view(S, -1, 3)) + lam * diagDp * vp
            if has_pl:
                y_aug = sh.halo_l.gather_aug(_bmv(Hll_inv, to_landmarks(vp))).flatten(0, 1)
                hp = hp - sh.segment_sum(torch.einsum("kij,kj->ki", C, y_aug[lm_k_flat]), pose_seg)
            return (hp * free_p + (1.0 - free_p) * v[0],)

        # the distributed chain + Woodbury-arrow preconditioner
        L_pre, U_pre = sh.chain_blocks(lin)
        sf = spike_factor(L_pre, _damped_or_eye(Dp, lam, sh.free_p, 3), U_pre, sh.boundary_block(lin), mesh)
        if has_pl:
            # dense V rows of OWN poses: (S, B, 3, 2 NL), global landmark columns
            Vd = sh.segment_sum(C.reshape(-1, 6), arrow_seg).view(S, B, NL, 3, 2)
            Vd = Vd.permute(0, 1, 3, 2, 4).reshape(S, B, 3, 2 * NL) * free_p[..., None]
            X = spike_solve(sf, Vd, mesh)  # distributed T^-1 V
            # the global arrow's diagonal: the owners' damped blocks on free
            # rows, psum'd, and identity on invalid rows (added replicated)
            contrib = torch.where(free_l[..., None] > 0, _damped_or_eye(Dl, lam, sh.free_l, 2), 0.0)
            A_diag = mesh.psum(sh.segment_sum(contrib.flatten(0, 1), owner_seg))[0]
            A_diag = A_diag + (1.0 - lm_free)[:, None, None] * torch.eye(2, dtype=dtype, device=dev)
            ar = torch.arange(NL, device=dev)
            A = A_diag.new_zeros((NL, 2, NL, 2))
            A[ar, :, ar, :] = A_diag
            V2, X2 = Vd.reshape(S, 3 * B, 2 * NL), X.reshape(S, 3 * B, 2 * NL)
            K = A.reshape(2 * NL, 2 * NL) - mesh.psum(V2.transpose(1, 2) @ X2)[0]
            K_lu, K_piv, _ = torch.linalg.lu_factor_ex(K)

            def precond(r):
                z = spike_solve(sf, r[0], mesh)
                w = mesh.psum((z.reshape(S, 1, 3 * B) @ V2)[:, 0])[0]
                u = torch.linalg.lu_solve(K_lu, K_piv, w[:, None])
                return (z + (X2 @ u).view(S, B, 3),)

        else:

            def precond(r):
                return (spike_solve(sf, r[0], mesh),)

        def recover_dl(dp):
            if not has_pl:
                return sh.lms0.new_zeros((S, BL, 2))
            return (ybl - _bmv(Hll_inv, to_landmarks(dp))) * free_l

        return smv, precond, (bs if has_pl else bp), recover_dl

    pb, lb = sh.poses0, sh.lms0
    trace = [chi2_of(pb, lb)]
    lam = torch.tensor(lm_lambda0, dtype=dtype, device=dev)
    nu = torch.full_like(lam, 2.0)
    cg_total = k = 0
    while k < iters:
        gk = sh.graph(pb, lb)
        lin = pg.linearize_se2(gk, huber_delta)
        chi2 = sh.chi2(lin)
        smv, precond, bs, recover_dl = build_system(gk, lin, lam)
        (dp,), cg_k, _ = pcg(smv, (bs,), precond, max_iters=cg_iters, rtol=cg_rtol, tree_dot=sh.dot)
        dp = dp * free_p
        dl = recover_dl(dp)
        new_pb = pb + dp
        new_pb = torch.cat([new_pb[..., :2], lie.wrap_angle(new_pb[..., 2:])], -1)
        new_lb = lb + dl
        new_chi2 = chi2_of(new_pb, new_lb)
        accept = torch.isfinite(new_chi2) & (new_chi2 < chi2)
        rel_drop = (chi2 - new_chi2) / torch.clamp_min(chi2, 1e-30)
        done = (accept & (rel_drop < tol)) | (~accept & (lam >= 1e10))
        lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-12), torch.clamp_max(lam * nu, 1e10))
        nu = torch.where(accept, 2.0, torch.clamp_max(nu * 2.0, 64.0))
        pb = torch.where(accept, new_pb, pb)
        lb = torch.where(accept, new_lb, lb)
        trace.append(torch.where(accept, new_chi2, chi2))
        cg_total += cg_k
        k += 1
        if bool(done):  # a replicated flag: every shard leaves at the same iteration
            break
    trace += [trace[-1]] * (iters + 1 - len(trace))

    g_out = g.with_poses(sh.blocks_of(pb, g.poses), sh.lms_of(lb, g.landmarks))
    stats = {
        "partition": partition_stats(part),
        "comm": comm_volume(part, k, cg_total),
        "cg_total": cg_total,
        "lm_iters": k,
        # replicated psum floats this solver adds beyond the halo bytes:
        # per CG iter: interface rhs (2D*3) [precond] + arrow w (2NL);
        # per LM iter: interface assembly (~(2D*3)^2), X interface rhs
        # (2D*3*2NL), K psum ((2NL)^2), A_diag (4NL)
        "spike_bytes_per_solve": spike_solve_bytes(n_dev, 3),
        "replicated_psum_floats_per_cg_iter": 2 * n_dev * 3 + 2 * NL,
        "replicated_psum_floats_per_lm_iter": (
            (2 * n_dev * 3) ** 2 + 2 * n_dev * 3 * 2 * NL + (2 * NL) ** 2 + 4 * NL
        ),
    }
    return g_out, torch.stack(trace), stats
