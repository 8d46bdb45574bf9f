"""Float64 host control solver — the trusted accuracy reference.

BASELINE.md requires accuracy "established by running the reference protocol
as the control"; the reference's backend is g2o + CHOLMOD sparse Cholesky
(``map_g2o_reflector.h:50-74``, ``CMakeLists.txt:105-112``). This module
plays that role in-tree: a float64 sparse-Cholesky Gauss-Newton/LM solver
(scipy.sparse) over the same SE2 pose+landmark graphs, run to convergence on
the host. It is deliberately NOT the TPU path — different precision,
different linear algebra, independent code — so agreement is evidence, not
tautology. Results are pinned in EVAL.md ("chi2 @ control vs chi2 @ ours").

The port's own copy of ``g2o_frontend_tpu/solvers/control.py`` (numpy and
scipy only): the port imports nothing of the JAX package, so the two
copies are kept equal by hand. It reads any graph whose fields convert
with ``np.asarray``, the port's tensors (on the CPU) included.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _se2_rel(xi, xj):
    c, s = np.cos(xi[..., 2]), np.sin(xi[..., 2])
    dx = xj[..., 0] - xi[..., 0]
    dy = xj[..., 1] - xi[..., 1]
    return np.stack(
        [c * dx + s * dy, -s * dx + c * dy, _wrap(xj[..., 2] - xi[..., 2])], -1
    )


def _pp_residual_jac(xi, xj, z):
    """Batched residual + analytic Jacobians for SE2 pose-pose edges."""
    c, s = np.cos(xi[:, 2]), np.sin(xi[:, 2])
    dx = xj[:, 0] - xi[:, 0]
    dy = xj[:, 1] - xi[:, 1]
    e = np.stack(
        [c * dx + s * dy, -s * dx + c * dy, _wrap(xj[:, 2] - xi[:, 2] - z[:, 2])],
        -1,
    )
    e[:, :2] -= z[:, :2]
    E = len(xi)
    Ji = np.zeros((E, 3, 3))
    Jj = np.zeros((E, 3, 3))
    Ji[:, 0, 0] = -c
    Ji[:, 0, 1] = -s
    Ji[:, 0, 2] = -s * dx + c * dy
    Ji[:, 1, 0] = s
    Ji[:, 1, 1] = -c
    Ji[:, 1, 2] = -c * dx - s * dy
    Ji[:, 2, 2] = -1.0
    Jj[:, 0, 0] = c
    Jj[:, 0, 1] = s
    Jj[:, 1, 0] = -s
    Jj[:, 1, 1] = c
    Jj[:, 2, 2] = 1.0
    return e, Ji, Jj


def _pl_residual_jac(xp, ll, z):
    """Batched residual + Jacobians for SE2 pose -> XY landmark edges."""
    c, s = np.cos(xp[:, 2]), np.sin(xp[:, 2])
    dx = ll[:, 0] - xp[:, 0]
    dy = ll[:, 1] - xp[:, 1]
    e = np.stack([c * dx + s * dy - z[:, 0], -s * dx + c * dy - z[:, 1]], -1)
    E = len(xp)
    Jp = np.zeros((E, 2, 3))
    Jl = np.zeros((E, 2, 2))
    Jp[:, 0, 0] = -c
    Jp[:, 0, 1] = -s
    Jp[:, 0, 2] = -s * dx + c * dy
    Jp[:, 1, 0] = s
    Jp[:, 1, 1] = -c
    Jp[:, 1, 2] = -c * dx - s * dy
    Jl[:, 0, 0] = c
    Jl[:, 0, 1] = s
    Jl[:, 1, 0] = -s
    Jl[:, 1, 1] = c
    return e, Jp, Jl


def control_optimize_se2(
    g,
    max_iters: int = 100,
    tol: float = 1e-9,
    lm_lambda0: float = 1e-6,
):
    """LM to convergence in float64 with sparse Cholesky (splu).

    Args:
      g: a PoseGraph2D (jax or numpy arrays).
    Returns dict with optimized poses/landmarks, chi2 trace, final chi2.
    """
    poses = np.asarray(g.poses, np.float64).copy()
    lms = np.asarray(g.landmarks, np.float64).copy()
    pose_mask = np.asarray(g.pose_mask)
    lm_mask = np.asarray(g.landmark_mask)
    fixed = np.asarray(g.fixed)
    pp_ij = np.asarray(g.pp_ij)[np.asarray(g.pp_mask)]
    pp_z = np.asarray(g.pp_meas, np.float64)[np.asarray(g.pp_mask)]
    pp_w = np.asarray(g.pp_info, np.float64)[np.asarray(g.pp_mask)]
    pl_ij = np.asarray(g.pl_ij)[np.asarray(g.pl_mask)]
    pl_z = np.asarray(g.pl_meas, np.float64)[np.asarray(g.pl_mask)]
    pl_w = np.asarray(g.pl_info, np.float64)[np.asarray(g.pl_mask)]

    NP = len(poses)
    NL = len(lms)
    n_dof = 3 * NP + 2 * NL
    free = np.zeros(n_dof, bool)
    for p in range(NP):
        free[3 * p : 3 * p + 3] = pose_mask[p] and not fixed[p]
    for l in range(NL):
        free[3 * NP + 2 * l : 3 * NP + 2 * l + 2] = lm_mask[l]
    free_idx = np.where(free)[0]

    def chi2_of(poses, lms):
        e = _se2_rel(poses[pp_ij[:, 0]], poses[pp_ij[:, 1]]) - pp_z
        e[:, 2] = _wrap(e[:, 2])
        c = np.einsum("ki,kij,kj->", e, pp_w, e)
        if len(pl_ij):
            ep, _, _ = _pl_residual_jac(poses[pl_ij[:, 0]], lms[pl_ij[:, 1]], pl_z)
            c += np.einsum("ki,kij,kj->", ep, pl_w, ep)
        return float(c)

    lam = lm_lambda0
    trace = [chi2_of(poses, lms)]
    for it in range(max_iters):
        e, Ji, Jj = _pp_residual_jac(poses[pp_ij[:, 0]], poses[pp_ij[:, 1]], pp_z)
        rows, cols, vals = [], [], []
        bvec = np.zeros(n_dof)

        def add_block(r0, c0, blk):
            rr, cc = np.meshgrid(
                np.arange(blk.shape[-2]), np.arange(blk.shape[-1]), indexing="ij"
            )
            rows.append((r0[:, None, None] + rr[None]).ravel())
            cols.append((c0[:, None, None] + cc[None]).ravel())
            vals.append(blk.ravel())

        i0 = 3 * pp_ij[:, 0]
        j0 = 3 * pp_ij[:, 1]
        WJi = np.einsum("kde,kei->kdi", pp_w, Ji)
        WJj = np.einsum("kde,kei->kdi", pp_w, Jj)
        add_block(i0, i0, np.einsum("kdi,kdj->kij", Ji, WJi))
        add_block(i0, j0, np.einsum("kdi,kdj->kij", Ji, WJj))
        add_block(j0, i0, np.einsum("kdi,kdj->kij", Jj, WJi))
        add_block(j0, j0, np.einsum("kdi,kdj->kij", Jj, WJj))
        We = np.einsum("kde,ke->kd", pp_w, e)
        np.add.at(bvec, (i0[:, None] + np.arange(3)[None]).ravel(),
                  np.einsum("kdi,kd->ki", Ji, We).ravel())
        np.add.at(bvec, (j0[:, None] + np.arange(3)[None]).ravel(),
                  np.einsum("kdi,kd->ki", Jj, We).ravel())

        if len(pl_ij):
            ep, Jp, Jl = _pl_residual_jac(
                poses[pl_ij[:, 0]], lms[pl_ij[:, 1]], pl_z
            )
            p0 = 3 * pl_ij[:, 0]
            l0 = 3 * NP + 2 * pl_ij[:, 1]
            WJp = np.einsum("kde,kei->kdi", pl_w, Jp)
            WJl = np.einsum("kde,kei->kdi", pl_w, Jl)
            add_block(p0, p0, np.einsum("kdi,kdj->kij", Jp, WJp))
            add_block(p0, l0, np.einsum("kdi,kdj->kij", Jp, WJl))
            add_block(l0, p0, np.einsum("kdi,kdj->kij", Jl, WJp))
            add_block(l0, l0, np.einsum("kdi,kdj->kij", Jl, WJl))
            Wep = np.einsum("kde,ke->kd", pl_w, ep)
            np.add.at(bvec, (p0[:, None] + np.arange(3)[None]).ravel(),
                      np.einsum("kdi,kd->ki", Jp, Wep).ravel())
            np.add.at(bvec, (l0[:, None] + np.arange(2)[None]).ravel(),
                      np.einsum("kdi,kd->ki", Jl, Wep).ravel())

        H = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_dof, n_dof),
        ).tocsc()
        Hff = H[free_idx][:, free_idx]
        bf = bvec[free_idx]
        Hff = Hff + lam * sp.diags(Hff.diagonal() + 1e-12)
        try:
            dx_f = spla.splu(Hff.tocsc()).solve(-bf)
        except RuntimeError:
            lam = min(lam * 10, 1e8)
            continue
        dx = np.zeros(n_dof)
        dx[free_idx] = dx_f

        new_poses = poses + dx[: 3 * NP].reshape(NP, 3)
        new_poses[:, 2] = _wrap(new_poses[:, 2])
        new_lms = lms + dx[3 * NP :].reshape(NL, 2)
        new_chi2 = chi2_of(new_poses, new_lms)
        if new_chi2 < trace[-1]:
            poses, lms = new_poses, new_lms
            rel_drop = (trace[-1] - new_chi2) / max(trace[-1], 1e-300)
            trace.append(new_chi2)
            lam = max(lam * 0.3, 1e-12)
            if rel_drop < tol:
                break
        else:
            lam = min(lam * 10, 1e8)
            trace.append(trace[-1])
            if lam >= 1e8:
                break
    return {
        "poses": poses,
        "landmarks": lms,
        "chi2": trace[-1],
        "trace": np.asarray(trace),
        "iters": len(trace) - 1,
    }


# ---------------------------------------------------------------------------
# SE3 control (graphSE3 / reflector-built PWN-SLAM graphs) — VERDICT r3 Next 2
# ---------------------------------------------------------------------------
# Float64 numpy throughout, fully independent of the JAX path: quaternion ->
# matrix, batched SO3/SE3 log/exp, residual e = log(Z^-1 Xi^-1 Xj) exactly as
# the reference's EdgeSE3 error (g2o types mirrored by
# ``boss_map_building/map_g2o_reflector.h:15-48``), Jacobians by central
# finite differences in the local twist chart, sparse-Cholesky (splu) LM.


def _q_to_R(q):
    """Batched [qx qy qz qw] -> (N,3,3) rotation matrices, float64."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _pose7_to_T64(p):
    p = np.asarray(p, np.float64)
    T = np.tile(np.eye(4), p.shape[:-1] + (1, 1))
    T[..., :3, :3] = _q_to_R(p[..., 3:7])
    T[..., :3, 3] = p[..., :3]
    return T


def _T_to_pose7_64(T):
    """(…,4,4) -> (…,7) [t, qx qy qz qw] (Shepperd's method, batched)."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    out = np.empty(T.shape[:-2] + (7,))
    out[..., :3] = T[..., :3, 3]
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q = np.empty(T.shape[:-2] + (4,))  # wxyz scratch
    # branchless-ish: compute all four candidates, pick the best-conditioned
    c0 = np.sqrt(np.maximum(1.0 + tr, 1e-300)) / 2
    c1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 1e-300)) / 2
    c2 = np.sqrt(np.maximum(1.0 - m00 + m11 - m22, 1e-300)) / 2
    c3 = np.sqrt(np.maximum(1.0 - m00 - m11 + m22, 1e-300)) / 2
    choice = np.argmax(np.stack([c0, c1, c2, c3], -1), -1)
    w0 = np.stack([c0,
                   (R[..., 2, 1] - R[..., 1, 2]) / (4 * c0),
                   (R[..., 0, 2] - R[..., 2, 0]) / (4 * c0),
                   (R[..., 1, 0] - R[..., 0, 1]) / (4 * c0)], -1)
    w1 = np.stack([(R[..., 2, 1] - R[..., 1, 2]) / (4 * c1), c1,
                   (R[..., 0, 1] + R[..., 1, 0]) / (4 * c1),
                   (R[..., 0, 2] + R[..., 2, 0]) / (4 * c1)], -1)
    w2 = np.stack([(R[..., 0, 2] - R[..., 2, 0]) / (4 * c2),
                   (R[..., 0, 1] + R[..., 1, 0]) / (4 * c2), c2,
                   (R[..., 1, 2] + R[..., 2, 1]) / (4 * c2)], -1)
    w3 = np.stack([(R[..., 1, 0] - R[..., 0, 1]) / (4 * c3),
                   (R[..., 0, 2] + R[..., 2, 0]) / (4 * c3),
                   (R[..., 1, 2] + R[..., 2, 1]) / (4 * c3), c3], -1)
    cand = np.stack([w0, w1, w2, w3], -2)
    q = np.take_along_axis(cand, choice[..., None, None].repeat(4, -1),
                           -2)[..., 0, :]
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    out[..., 3] = q[..., 1]
    out[..., 4] = q[..., 2]
    out[..., 5] = q[..., 3]
    out[..., 6] = q[..., 0]
    return out


def _skew64(w):
    W = np.zeros(w.shape[:-1] + (3, 3))
    W[..., 0, 1] = -w[..., 2]
    W[..., 0, 2] = w[..., 1]
    W[..., 1, 0] = w[..., 2]
    W[..., 1, 2] = -w[..., 0]
    W[..., 2, 0] = -w[..., 1]
    W[..., 2, 1] = w[..., 0]
    return W


def _so3_log64(R):
    """Batched rotation log, robust near 0 and pi."""
    tr = np.clip((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2, -1, 1)
    th = np.arccos(tr)
    ax = np.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], -1)
    small = th < 1e-7
    near_pi = th > np.pi - 1e-4
    s = np.where(small, 1.0, 2 * np.sin(th))
    w = ax * (th / s)[..., None]
    w = np.where(small[..., None], ax / 2.0, w)
    if np.any(near_pi):
        # axis from the symmetric part: R ~ 2 aa^T - I at th = pi
        idx = np.where(near_pi)
        for k in zip(*idx):
            Rk = R[k]
            A = (Rk + np.eye(3)) / 2.0
            a = np.sqrt(np.maximum(np.diagonal(A), 0.0))
            j = int(np.argmax(a))
            axis = A[:, j] / max(a[j], 1e-12)
            axis = axis / np.linalg.norm(axis)
            # fix sign from the skew part
            sk = np.array([Rk[2, 1] - Rk[1, 2], Rk[0, 2] - Rk[2, 0],
                           Rk[1, 0] - Rk[0, 1]])
            if np.dot(sk, axis) < 0:
                axis = -axis
            w[k] = axis * th[k]
    return w


def _se3_log64(T):
    w = _so3_log64(T[..., :3, :3])
    th2 = np.sum(w * w, -1)
    th = np.sqrt(th2)
    W = _skew64(w)
    cot = np.where(
        th2 > 1e-10,
        (1.0 - th * np.sin(th) / (2 * np.maximum(1 - np.cos(th), 1e-300)))
        / np.maximum(th2, 1e-300),
        1.0 / 12.0,
    )
    eye = np.broadcast_to(np.eye(3), W.shape)
    Vinv = eye - 0.5 * W + cot[..., None, None] * (W @ W)
    v = np.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return np.concatenate([v, w], -1)


def _se3_exp64(xi):
    v, w = xi[..., :3], xi[..., 3:]
    th2 = np.sum(w * w, -1)
    th = np.sqrt(th2)
    W = _skew64(w)
    a = np.where(th2 > 1e-10, np.sin(th) / np.maximum(th, 1e-300),
                 1.0 - th2 / 6.0)
    b = np.where(th2 > 1e-10, (1 - np.cos(th)) / np.maximum(th2, 1e-300),
                 0.5 - th2 / 24.0)
    c = np.where(th2 > 1e-10,
                 (th - np.sin(th)) / np.maximum(th2 * th, 1e-300),
                 1.0 / 6.0 - th2 / 120.0)
    eye = np.broadcast_to(np.eye(3), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    T = np.tile(np.eye(4), xi.shape[:-1] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = np.einsum("...ij,...j->...i", V, v)
    return T


def _se3_edge_residual(Ti, Tj, Zinv):
    return _se3_log64(Zinv @ (np.linalg.inv(Ti) @ Tj))


def control_optimize_se3(
    g,
    max_iters: int = 100,
    tol: float = 1e-10,
    lm_lambda0: float = 1e-8,
    fd_eps: float = 1e-6,
):
    """Float64 sparse-Cholesky LM for SE3 pose graphs (PoseGraph3D).

    Residual convention matches the TPU path (solvers/pose_graph.py
    linearize_se3) and the reference's EdgeSE3 so chi2 values compare
    directly. Jacobians by central differences in the right-multiplied
    local twist chart.
    """
    pose_mask = np.asarray(g.pose_mask)
    fixed = np.asarray(g.fixed)
    pp_mask = np.asarray(g.pp_mask)
    pp_ij = np.asarray(g.pp_ij)[pp_mask]
    Z = _pose7_to_T64(np.asarray(g.pp_meas)[pp_mask])
    Zinv = np.linalg.inv(Z)
    W = np.asarray(g.pp_info, np.float64)[pp_mask]
    T = _pose7_to_T64(np.asarray(g.poses))
    NP = len(T)
    # a free pose with no incident edges leaves its 6x6 Hff block all-zero:
    # splu fails, lambda climbs, iterations burn without converging
    # (ADVICE r4) — mark such poses non-free up front
    incident = np.zeros(NP, np.int64)
    np.add.at(incident, pp_ij[:, 0], 1)
    np.add.at(incident, pp_ij[:, 1], 1)
    free = np.zeros(6 * NP, bool)
    for p in range(NP):
        free[6 * p : 6 * p + 6] = (
            pose_mask[p] and not fixed[p] and incident[p] > 0
        )
    # gauge: if nothing is fixed, fix the first valid pose (g2o convention)
    if not np.any(fixed & pose_mask):
        first = int(np.where(pose_mask)[0][0])
        free[6 * first : 6 * first + 6] = False
    free_idx = np.where(free)[0]

    def chi2_of(T):
        e = _se3_edge_residual(T[pp_ij[:, 0]], T[pp_ij[:, 1]], Zinv)
        return float(np.einsum("ki,kij,kj->", e, W, e))

    lam = lm_lambda0
    trace = [chi2_of(T)]
    E = len(pp_ij)
    for it in range(max_iters):
        Ti, Tj = T[pp_ij[:, 0]], T[pp_ij[:, 1]]
        e = _se3_edge_residual(Ti, Tj, Zinv)
        Ji = np.zeros((E, 6, 6))
        Jj = np.zeros((E, 6, 6))
        for m in range(6):
            d = np.zeros(6)
            d[m] = fd_eps
            Dp = _se3_exp64(d)
            Dm = _se3_exp64(-d)
            Ji[:, :, m] = (
                _se3_edge_residual(Ti @ Dp, Tj, Zinv)
                - _se3_edge_residual(Ti @ Dm, Tj, Zinv)
            ) / (2 * fd_eps)
            Jj[:, :, m] = (
                _se3_edge_residual(Ti, Tj @ Dp, Zinv)
                - _se3_edge_residual(Ti, Tj @ Dm, Zinv)
            ) / (2 * fd_eps)

        rows, cols, vals = [], [], []
        bvec = np.zeros(6 * NP)

        def add_block(r0, c0, blk):
            rr, cc = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
            rows.append((r0[:, None, None] + rr[None]).ravel())
            cols.append((c0[:, None, None] + cc[None]).ravel())
            vals.append(blk.ravel())

        i0 = 6 * pp_ij[:, 0]
        j0 = 6 * pp_ij[:, 1]
        WJi = np.einsum("kde,kei->kdi", W, Ji)
        WJj = np.einsum("kde,kei->kdi", W, Jj)
        add_block(i0, i0, np.einsum("kdi,kdj->kij", Ji, WJi))
        add_block(i0, j0, np.einsum("kdi,kdj->kij", Ji, WJj))
        add_block(j0, i0, np.einsum("kdi,kdj->kij", Jj, WJi))
        add_block(j0, j0, np.einsum("kdi,kdj->kij", Jj, WJj))
        We = np.einsum("kde,ke->kd", W, e)
        np.add.at(bvec, (i0[:, None] + np.arange(6)[None]).ravel(),
                  np.einsum("kdi,kd->ki", Ji, We).ravel())
        np.add.at(bvec, (j0[:, None] + np.arange(6)[None]).ravel(),
                  np.einsum("kdi,kd->ki", Jj, We).ravel())

        H = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(6 * NP, 6 * NP),
        ).tocsc()
        Hff = H[free_idx][:, free_idx]
        bf = bvec[free_idx]
        Hff = Hff + lam * sp.diags(Hff.diagonal() + 1e-12)
        try:
            dx_f = spla.splu(Hff.tocsc()).solve(-bf)
        except RuntimeError:
            lam = min(lam * 10, 1e8)
            continue
        dx = np.zeros(6 * NP)
        dx[free_idx] = dx_f
        T_new = T @ _se3_exp64(dx.reshape(NP, 6))
        new_chi2 = chi2_of(T_new)
        if new_chi2 < trace[-1]:
            T = T_new
            rel_drop = (trace[-1] - new_chi2) / max(trace[-1], 1e-300)
            trace.append(new_chi2)
            lam = max(lam * 0.3, 1e-14)
            if rel_drop < tol:
                break
        else:
            lam = min(lam * 10, 1e8)
            trace.append(trace[-1])
            if lam >= 1e8:
                break
    return {
        "poses": _T_to_pose7_64(T),
        "chi2": trace[-1],
        "trace": np.asarray(trace),
        "iters": len(trace) - 1,
    }


# ---------------------------------------------------------------------------
# BA control (3D-observation bundle adjustment) — VERDICT r3 Next 2
# ---------------------------------------------------------------------------


def control_optimize_ba(
    ba,
    max_iters: int = 100,
    tol: float = 1e-10,
    lm_lambda0: float = 1e-8,
):
    """Float64 dense-Cholesky LM for BAProblem (solvers/ba.py semantics).

    Residual ``e = R^T (p_w - t) - z`` with analytic Jacobians in the same
    right-multiplied twist chart as the TPU path: for X' = X exp([v, w]),
    de/dv = -I, de/dw = skew(R^T (p - t)), de/dp = R^T. Small dense system
    (test problems), solved exactly.
    """
    pose_mask = np.asarray(ba.pose_mask)
    point_mask = np.asarray(ba.point_mask)
    fixed = np.asarray(ba.fixed)
    obs_mask = np.asarray(ba.obs_mask)
    obs_ij = np.asarray(ba.obs_ij)[obs_mask]
    z = np.asarray(ba.obs_z, np.float64)[obs_mask]
    W = np.asarray(ba.obs_info, np.float64)[obs_mask]
    T = _pose7_to_T64(np.asarray(ba.poses))
    pts = np.asarray(ba.points, np.float64).copy()
    NP, NL = len(T), len(pts)
    n_dof = 6 * NP + 3 * NL
    # zero-incidence poses/points leave singular diagonal blocks (ADVICE
    # r4): mark them non-free
    inc_p = np.zeros(NP, np.int64)
    inc_l = np.zeros(NL, np.int64)
    np.add.at(inc_p, obs_ij[:, 0], 1)
    np.add.at(inc_l, obs_ij[:, 1], 1)
    free = np.zeros(n_dof, bool)
    for p in range(NP):
        free[6 * p : 6 * p + 6] = (
            pose_mask[p] and not fixed[p] and inc_p[p] > 0
        )
    for l in range(NL):
        free[6 * NP + 3 * l : 6 * NP + 3 * l + 3] = (
            point_mask[l] and inc_l[l] > 0
        )
    free_idx = np.where(free)[0]

    def residuals(T, pts):
        R = T[obs_ij[:, 0], :3, :3]
        t = T[obs_ij[:, 0], :3, 3]
        p = pts[obs_ij[:, 1]]
        q = np.einsum("kji,kj->ki", R, p - t)
        return q - z, R, q

    def chi2_of(T, pts):
        e, _, _ = residuals(T, pts)
        return float(np.einsum("ki,kij,kj->", e, W, e))

    lam = lm_lambda0
    trace = [chi2_of(T, pts)]
    for it in range(max_iters):
        e, R, q = residuals(T, pts)
        E = len(e)
        Jc = np.zeros((E, 3, 6))
        Jc[:, :, :3] = -np.broadcast_to(np.eye(3), (E, 3, 3))
        Jc[:, :, 3:] = _skew64(q)
        Jp = np.transpose(R, (0, 2, 1))

        H = np.zeros((n_dof, n_dof))
        b = np.zeros(n_dof)
        WJc = np.einsum("kde,kei->kdi", W, Jc)
        WJp = np.einsum("kde,kei->kdi", W, Jp)
        Hcc = np.einsum("kdi,kdj->kij", Jc, WJc)
        Hcp = np.einsum("kdi,kdj->kij", Jc, WJp)
        Hpp = np.einsum("kdi,kdj->kij", Jp, WJp)
        We = np.einsum("kde,ke->kd", W, e)
        bc = np.einsum("kdi,kd->ki", Jc, We)
        bp = np.einsum("kdi,kd->ki", Jp, We)
        for k in range(E):
            i0 = 6 * obs_ij[k, 0]
            l0 = 6 * NP + 3 * obs_ij[k, 1]
            H[i0:i0 + 6, i0:i0 + 6] += Hcc[k]
            H[i0:i0 + 6, l0:l0 + 3] += Hcp[k]
            H[l0:l0 + 3, i0:i0 + 6] += Hcp[k].T
            H[l0:l0 + 3, l0:l0 + 3] += Hpp[k]
            b[i0:i0 + 6] += bc[k]
            b[l0:l0 + 3] += bp[k]

        Hff = H[np.ix_(free_idx, free_idx)]
        Hff = Hff + lam * np.diag(np.diag(Hff) + 1e-12)
        try:
            dx_f = np.linalg.solve(Hff, -b[free_idx])
        except np.linalg.LinAlgError:
            lam = min(lam * 10, 1e8)
            continue
        dx = np.zeros(n_dof)
        dx[free_idx] = dx_f
        T_new = T @ _se3_exp64(dx[: 6 * NP].reshape(NP, 6))
        pts_new = pts + dx[6 * NP :].reshape(NL, 3)
        new_chi2 = chi2_of(T_new, pts_new)
        if new_chi2 < trace[-1]:
            T, pts = T_new, pts_new
            rel_drop = (trace[-1] - new_chi2) / max(trace[-1], 1e-300)
            trace.append(new_chi2)
            lam = max(lam * 0.3, 1e-14)
            if rel_drop < tol:
                break
        else:
            lam = min(lam * 10, 1e8)
            trace.append(trace[-1])
            if lam >= 1e8:
                break
    return {
        "poses": _T_to_pose7_64(T),
        "points": pts,
        "chi2": trace[-1],
        "trace": np.asarray(trace),
        "iters": len(trace) - 1,
    }
