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

The JAX ``lax.while_loop`` and its convergence flag become a host loop
that reads one replicated flag an LM iteration (the same on every shard).
"""
from __future__ import annotations

import torch

from ..graph.store import PoseGraph2D
from ..solvers import pose_graph as pg
from ..solvers.pcg import pcg
from ..solvers.schur_pcg import _damped_blocks
from ..utils import lie
from .partitioned_pose_graph import _bmv, _Shards2D, comm_volume, partition_se2, partition_stats
from .spike import spike_factor, spike_solve, spike_solve_bytes

MAX_LANDMARKS = 4096  # the Woodbury arrow replicates a (2 NL)^2 matrix


def _damped_or_eye(D, lam, free, d):
    """`schur_pcg._damped_blocks` (D + lam diag(D) + 1e-10 I on free blocks,
    I elsewhere) on (S, n, d, d) blocks."""
    return _damped_blocks(D.flatten(0, 1), lam, free.flatten(), d).view(D.shape)


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

    def chi2_of(pb, lb):
        return sh.chi2(pg.linearize_se2(sh.graph(pb, lb), huber_delta))

    def build_system(gk, lin, lam):
        """The distributed `schur_pcg.build_schur_system`."""
        gp, gl = sh.reduce(*pg._grad_se2(gk, lin))
        Dp, Dl = sh.reduce(*pg._diag_blocks_se2(gk, lin))
        bp = -gp * free_p
        edge_hvp = pg._hvp_edges_se2(gk, lin)
        diagDp = torch.diagonal(Dp, dim1=-2, dim2=-1)
        zeros_l = gk.landmarks.new_zeros(gk.landmarks.shape)
        if has_pl:
            C = pg._jtwj(lin.Jp_pl, lin.w_pl, lin.Jl_pl)  # (S * EL, 3, 2)
            Hll_inv = pg._inv(_damped_or_eye(Dl, lam, sh.free_l, 2))
            ybl = _bmv(Hll_inv, -gl * free_l)
            ybl_aug = sh.halo_l.gather_aug(ybl).flatten(0, 1)
            bs = bp - free_p * sh.segment_sum(torch.einsum("kij,kj->ki", C, ybl_aug[lm_k_flat]), pose_k, B)

        def to_landmarks(vp):
            """Own landmark blocks of sum_k C_k^T vp[pose_k]."""
            t = sh.segment_sum(torch.einsum("kji,kj->ki", C, vp.flatten(0, 1)[pose_k_flat]), lm_k, BL + GL)
            return sh.halo_l.reduce(t)

        def smv(v):
            vp = v[0] * free_p
            hp_aug, _ = edge_hvp((sh.halo.gather_aug(vp).flatten(0, 1), zeros_l))
            hp = sh.halo.reduce(hp_aug.view(S, -1, 3)) + lam * diagDp * vp
            if has_pl:
                y_aug = sh.halo_l.gather_aug(_bmv(Hll_inv, to_landmarks(vp))).flatten(0, 1)
                hp = hp - sh.segment_sum(torch.einsum("kij,kj->ki", C, y_aug[lm_k_flat]), pose_k, B)
            return (hp * free_p + (1.0 - free_p) * v[0],)

        # the distributed chain + Woodbury-arrow preconditioner
        L_pre, U_pre = sh.chain_blocks(lin)
        sf = spike_factor(L_pre, _damped_or_eye(Dp, lam, sh.free_p, 3), U_pre, sh.boundary_block(lin), mesh)
        if has_pl:
            # dense V rows of OWN poses: (S, B, 3, 2 NL), global landmark columns
            Vd = sh.segment_sum(C.reshape(-1, 6), pose_k * NL + gid_k, B * NL).view(S, B, NL, 3, 2)
            Vd = Vd.permute(0, 1, 3, 2, 4).reshape(S, B, 3, 2 * NL) * free_p[..., None]
            X = spike_solve(sf, Vd, mesh)  # distributed T^-1 V
            # the global arrow's diagonal: the owners' damped blocks on free
            # rows, psum'd, and identity on invalid rows (added replicated)
            contrib = torch.where(free_l[..., None] > 0, _damped_or_eye(Dl, lam, sh.free_l, 2), 0.0)
            A_diag = mesh.psum(sh.segment_sum(contrib.flatten(0, 1), sh.lm_gid[:, :BL], NL))[0]
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
