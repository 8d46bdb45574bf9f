"""Distributed Schur-complement + chain + Woodbury LM on the mesh
(counterpart of ``g2o_frontend_tpu/parallel/partitioned_schur.py``).

The single-device solver (`solvers/schur_pcg.py`: exact landmark Schur
elimination, the global chain tridiagonal by cyclic reduction, the full
landmark arrow through a Woodbury correction) on the mesh:

- **State stays partitioned** exactly as in `partitioned_pose_graph.py`:
  pose blocks in trajectory order, landmarks owned by the most-observing
  block, ghost directories and O(boundary) halo exchanges (`halo.py`).
- **The chain preconditioner goes distributed through SPIKE**
  (`spike.py`): each shard factors its local block tridiagonal; the (D-1)
  boundary couplings form a replicated (2D*3)^2 interface system
  assembled with one psum.
- **The landmark arrow stays exact**: the 2NL x 2NL Woodbury matrix
  ``K = A - V^T T^-1 V`` is psum-assembled from per-shard dense V slices
  (each shard holds the rows of its OWN poses) and LU-factored replicated;
  landmarks are few (victoriaPark: 151), poses many.

Per CG iteration the preconditioner is then the single-device
``M = T - V A^-1 V^T``; per-matvec communication is O(ghosts) halo bytes
plus O(D + NL) replicated psum floats, nothing O(N).

The JAX ``lax.while_loop`` runs through `utils.graphs.solve_loop` as
`solvers/schur_pcg.optimize_se2_schur`'s does: a head (linearize, the
reduced system and its preconditioner, CG's start), CG in blocks of
`pcg.BLOCK` masked steps with the psum'd stopping test on the device, and
a tail (back-substitution, accept or reject, lambda and nu, the
convergence flag), each a CUDA graph on the card. The flag, a replicated
value (the same on every shard), is read once an LM iteration with the
LM and CG counts.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import cg_carry
from ..solvers.schur_pcg import _damped_blocks
from ..utils import graphs, lie
from .partitioned_pose_graph import (_bmv, _Shards2D, cg_block_loop, comm_volume, partition_se2, partition_stats,
                                     shard_dot)
from .spike import spike_factor, spike_solve, spike_solve_bytes

MAX_LANDMARKS = 4096  # the Woodbury arrow replicates a (2 NL)^2 matrix


def _damped_or_eye(D, lam, free, d):
    """`schur_pcg._damped_blocks` (D + lam diag(D) + 1e-10 I on free blocks,
    I elsewhere) on (S, n, d, d) blocks."""
    return _damped_blocks(D.flatten(0, 1), lam, free.flatten(), d).view(D.shape)


class _Consts(NamedTuple):
    """The solve's index tensors, built once: every sum's `SegmentIndex`,
    the pose-landmark edges' rows of the flattened blocks, and the
    replicated landmark validity (identity rows of the global arrow A)."""

    seg: pg.EdgeSegments
    pose_seg: object
    lm_seg: object
    arrow_seg: object
    owner_seg: object
    pose_k_flat: torch.Tensor
    lm_k_flat: torch.Tensor
    lm_free: torch.Tensor


class _Params(NamedTuple):
    """The solve's static arguments (part of its graphs' key)."""

    has_pl: bool
    NL: int
    huber_delta: float | None
    tol: float
    cg_rtol: float


class _System(NamedTuple):
    """One LM iteration's reduced system and its preconditioner's factors."""

    bs: torch.Tensor
    diagDp: torch.Tensor
    zeros_l: torch.Tensor
    C: torch.Tensor | None
    Hll_inv: torch.Tensor | None
    ybl: torch.Tensor | None
    sf: object  # the SPIKE factor of the chain
    V2: torch.Tensor | None
    X2: torch.Tensor | None
    K_lu: torch.Tensor | None
    K_piv: torch.Tensor | None


class _Mid(NamedTuple):
    lin: pg.Linearization
    chi2: torch.Tensor
    lam: torch.Tensor
    sys: _System
    tol2: torch.Tensor


def _chi2_of(sh, prm, pb, lb):
    return sh.chi2(pg.linearize_se2(sh.graph(pb, lb), prm.huber_delta))


def _to_landmarks(sh, c, sys, vp):
    """Own landmark blocks of sum_k C_k^T vp[pose_k]."""
    t = sh.segment_sum(torch.einsum("kji,kj->ki", sys.C, vp.flatten(0, 1)[c.pose_k_flat]), c.lm_seg)
    return sh.halo_l.reduce(t)


def _system(sh, c, prm, gk, lin, lam) -> _System:
    """The distributed `schur_pcg.build_schur_system` and the chain +
    Woodbury-arrow preconditioner's factors."""
    S, B, NL, mesh = sh.S, sh.B, prm.NL, sh.mesh
    dtype, dev = gk.poses.dtype, gk.poses.device
    free_p, free_l = sh.free_p[..., None], sh.free_l[..., None]
    gp, gl = sh.reduce(*pg._grad_se2(gk, lin, c.seg))
    Dp, Dl = sh.reduce(*pg._diag_blocks_se2(gk, lin, c.seg))
    bp = -gp * free_p
    diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)
    zeros_l = gk.landmarks.new_zeros(gk.landmarks.shape)
    C = Hll_inv = ybl = V2 = X2 = K_lu = K_piv = None
    bs = bp
    if prm.has_pl:
        C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)  # (S * EL, 3, 2)
        Hll_inv = pg._inv(_damped_or_eye(Dl, lam, sh.free_l, 2))
        ybl = _bmv(Hll_inv, -gl * free_l)
        ybl_aug = sh.halo_l.gather_aug(ybl).flatten(0, 1)
        bs = bp - free_p * sh.segment_sum(torch.einsum("kij,kj->ki", C, ybl_aug[c.lm_k_flat]), c.pose_seg)
    # the distributed chain + Woodbury-arrow preconditioner
    L_pre, U_pre = sh.chain_blocks(lin)
    sf = spike_factor(L_pre, _damped_or_eye(Dp, lam, sh.free_p, 3), U_pre, sh.boundary_block(lin), mesh)
    if prm.has_pl:
        # dense V rows of OWN poses: (S, B, 3, 2 NL), global landmark columns
        Vd = sh.segment_sum(C.reshape(-1, 6), c.arrow_seg).view(S, B, NL, 3, 2)
        Vd = Vd.permute(0, 1, 3, 2, 4).reshape(S, B, 3, 2 * NL) * free_p[..., None]
        X = spike_solve(sf, Vd, mesh)  # distributed T^-1 V
        # the global arrow's diagonal: the owners' damped blocks on free
        # rows, psum'd, and identity on invalid rows (added replicated)
        contrib = torch.where(free_l[..., None] > 0, _damped_or_eye(Dl, lam, sh.free_l, 2), 0.0)
        A_diag = mesh.psum(sh.segment_sum(contrib.flatten(0, 1), c.owner_seg))[0]
        A_diag = A_diag + (1.0 - c.lm_free)[:, None, None] * torch.eye(2, dtype=dtype, device=dev)
        ar = torch.arange(NL, device=dev)
        A = A_diag.new_zeros((NL, 2, NL, 2))
        A[ar, :, ar, :] = A_diag
        V2, X2 = Vd.reshape(S, 3 * B, 2 * NL), X.reshape(S, 3 * B, 2 * NL)
        K = A.reshape(2 * NL, 2 * NL) - mesh.psum(V2.transpose(1, 2) @ X2)[0]
        K_lu, K_piv, _ = torch.linalg.lu_factor_ex(K)
    return _System(bs, diagDp, zeros_l, C, Hll_inv, ybl, sf, V2, X2, K_lu, K_piv)


def _head(inputs, st: pg.LMState):
    sh, c, prm = inputs
    gk = sh.graph(st.poses, st.lms)
    lin = pg.linearize_se2(gk, prm.huber_delta)
    mid = _Mid(lin, sh.chi2(lin), st.lam, _system(sh, c, prm, gk, lin, st.lam), None)
    carry, tol2 = cg_carry((mid.sys.bs,), _operators((inputs, mid))[1], prm.cg_rtol, partial(shard_dot, sh.mesh))
    return mid._replace(tol2=tol2), carry


def _operators(cs):
    (sh, c, prm), mid = cs
    S, B, sys, mesh = sh.S, sh.B, mid.sys, sh.mesh
    free_p = sh.free_p[..., None]
    edge_hvp = pg._hvp_edges_se2(sh.graph0, mid.lin, c.seg)

    def smv(v):
        vp = v[0] * free_p
        hp_aug, _ = edge_hvp((sh.halo.gather_aug(vp).flatten(0, 1), sys.zeros_l))
        hp = sh.halo.reduce(hp_aug.view(S, -1, 3)) + mid.lam * sys.diagDp * vp
        if prm.has_pl:
            y_aug = sh.halo_l.gather_aug(_bmv(sys.Hll_inv, _to_landmarks(sh, c, sys, vp))).flatten(0, 1)
            hp = hp - sh.segment_sum(torch.einsum("kij,kj->ki", sys.C, y_aug[c.lm_k_flat]), c.pose_seg)
        return (hp * free_p + (1.0 - free_p) * v[0],)

    if prm.has_pl:
        def precond(r):
            z = spike_solve(sys.sf, r[0], mesh)
            w = mesh.psum((z.reshape(S, 1, 3 * B) @ sys.V2)[:, 0])[0]
            u = torch.linalg.lu_solve(sys.K_lu, sys.K_piv, w[:, None])
            return (z + (sys.X2 @ u).view(S, B, 3),)
    else:
        def precond(r):
            return (spike_solve(sys.sf, r[0], mesh),)

    return smv, precond


def _tail(inputs, st: pg.LMState, mid: _Mid, carry) -> pg.LMState:
    """Back-substitute the landmarks, relinearize, accept or reject, and
    update lambda, nu, the trace and the convergence test."""
    sh, c, prm = inputs
    sys, chi2, lam, nu = mid.sys, mid.chi2, st.lam, st.nu
    dp = carry.x[0] * sh.free_p[..., None]
    if prm.has_pl:
        dl = (sys.ybl - _bmv(sys.Hll_inv, _to_landmarks(sh, c, sys, dp))) * sh.free_l[..., None]
    else:
        dl = st.lms.new_zeros((sh.S, sh.BL, 2))
    new_pb = st.poses + dp
    new_pb = torch.cat([new_pb[..., :2], lie.wrap_angle(new_pb[..., 2:])], -1)
    new_lb = st.lms + dl
    new_chi2 = _chi2_of(sh, prm, new_pb, new_lb)
    accept = torch.isfinite(new_chi2) & (new_chi2 < chi2)
    rel_drop = (chi2 - new_chi2) / torch.clamp_min(chi2, 1e-30)
    done = (accept & (rel_drop < prm.tol)) | (~accept & (lam >= 1e10))
    lam = torch.where(accept, torch.clamp_min(lam / 3.0, 1e-12), torch.clamp_max(lam * nu, 1e10))
    nu = torch.where(accept, 2.0, torch.clamp_max(nu * 2.0, 64.0))
    pb = torch.where(accept, new_pb, st.poses)
    lb = torch.where(accept, new_lb, st.lms)
    trace = pg.trace_put(st.trace, st.k, torch.where(accept, new_chi2, chi2))
    return pg.LMState(pb, lb, lam, trace, st.k + 1, st.cg_total + carry.k, nu, done)


def _report(st: pg.LMState):
    return torch.stack([st.done.to(torch.int64), st.k, st.cg_total])


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
    B, BL, GL = sh.B, sh.BL, sh.GL
    dev, dtype = sh.poses0.device, sh.poses0.dtype
    pose_k = sh.pl_ij[..., 0]  # always own slots (< B) by construction
    lm_k = sh.pl_ij[..., 1]  # own or ghost landmark slots
    gid_k = torch.gather(sh.lm_gid, 1, lm_k)  # global landmark column ids
    # every sum's index sorted once a solve; the edges as rows of the flattened (S * B) and (S * (BL + GL)) blocks
    c = _Consts(pg.edge_segments(sh.graph0), sh.segments(pose_k, B), sh.segments(lm_k, BL + GL),
                sh.segments(pose_k * NL + gid_k, B * NL), sh.segments(sh.lm_gid[:, :BL], NL),
                mesh.flat_index(pose_k, B), mesh.flat_index(lm_k, BL + GL),
                g.landmark_mask.to(device=dev, dtype=dtype))
    prm = _Params(NL > 0, NL, huber_delta, tol, cg_rtol)
    state = pg._start(sh.poses0, _chi2_of(sh, prm, sh.poses0, sh.lms0), lm_lambda0, iters, sh.lms0, stops=True)
    solve = graphs.Solve(_head, _tail, _report, cg_block_loop(_operators, mesh, cg_iters), stops=True)
    st, (_, k, cg_total) = graphs.solve_loop("optimize_se2_schur_partitioned", solve, (sh, c, prm), state, iters)

    g_out = g.with_poses(sh.blocks_of(st.poses, g.poses), sh.lms_of(st.lms, g.landmarks))
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
    return g_out, st.trace, stats
