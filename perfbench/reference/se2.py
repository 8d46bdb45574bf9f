"""Plain reference of the 2D landmark-SLAM backend: the `.g2o` file's
graph (SE2 poses, XY landmarks, pose-pose and pose-landmark edges, fixed
vertices), its chi2 and a Levenberg-Marquardt solve to the optimum with a
dense Cholesky factor of the whole system.

The residuals are g2o's EdgeSE2 and EdgeSE2PointXY errors, with analytic
Jacobians. Every matrix product goes through `precision.mm`, so the same
code runs in float64 (the optimum a solver is judged by) or, as the
control, in TF32. It imports nothing of the program under test.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .precision import dtype, mm


class Graph(NamedTuple):
    """A parsed SE2 graph, numpy, in file order."""

    poses: np.ndarray  # (NP, 3)
    landmarks: np.ndarray  # (NL, 2)
    fixed: np.ndarray  # (NP,) bool
    pp_ij: np.ndarray  # (EP, 2) rows
    pp_z: np.ndarray  # (EP, 3)
    pp_info: np.ndarray  # (EP, 3, 3)
    pl_ij: np.ndarray  # (EL, 2) pose row, landmark row
    pl_z: np.ndarray  # (EL, 2)
    pl_info: np.ndarray  # (EL, 2, 2)


def _full(upper, n):
    M = np.zeros((n, n))
    M[np.triu_indices(n)] = upper
    return M + np.triu(M, 1).T


def parse_g2o(text: str) -> Graph:
    """VERTEX_SE2, VERTEX_XY, FIX, EDGE_SE2 and EDGE_SE2_XY records."""
    poses, lms, fixed, pp, pl = {}, {}, set(), [], []
    for line in text.splitlines():
        f = line.split()
        if not f:
            continue
        if f[0] == "VERTEX_SE2":
            poses[int(f[1])] = [float(v) for v in f[2:5]]
        elif f[0] == "VERTEX_XY":
            lms[int(f[1])] = [float(v) for v in f[2:4]]
        elif f[0] == "FIX":
            fixed.update(int(v) for v in f[1:])
        elif f[0] == "EDGE_SE2":
            pp.append((int(f[1]), int(f[2]), [float(v) for v in f[3:6]], _full([float(v) for v in f[6:12]], 3)))
        elif f[0] == "EDGE_SE2_XY":
            pl.append((int(f[1]), int(f[2]), [float(v) for v in f[3:5]], _full([float(v) for v in f[5:8]], 2)))
    prow = {vid: k for k, vid in enumerate(poses)}
    lrow = {vid: k for k, vid in enumerate(lms)}
    fix = np.zeros(len(poses), bool)
    for vid in fixed:
        if vid in prow:
            fix[prow[vid]] = True
    return Graph(
        np.asarray(list(poses.values()), np.float64).reshape(-1, 3),
        np.asarray(list(lms.values()), np.float64).reshape(-1, 2), fix,
        np.asarray([(prow[i], prow[j]) for i, j, _, _ in pp], np.int64).reshape(-1, 2),
        np.asarray([z for _, _, z, _ in pp], np.float64).reshape(-1, 3),
        np.asarray([w for _, _, _, w in pp], np.float64).reshape(-1, 3, 3),
        np.asarray([(prow[i], lrow[j]) for i, j, _, _ in pl], np.int64).reshape(-1, 2),
        np.asarray([z for _, _, z, _ in pl], np.float64).reshape(-1, 2),
        np.asarray([w for _, _, _, w in pl], np.float64).reshape(-1, 2, 2),
    )


def _wrap(a):
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


def _rotT(th):
    """R(th)^T as (..., 2, 2)."""
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)


class Problem:
    """The graph's tensors on one device in one precision."""

    def __init__(self, g: Graph, device, precision="float64"):
        self.precision = precision
        dt = dtype(precision)
        t = lambda a, d=dt: torch.as_tensor(a, dtype=d, device=device)  # noqa: E731
        self.NP, self.NL = len(g.poses), len(g.landmarks)
        self.pp_i, self.pp_j = t(g.pp_ij[:, 0], torch.int64), t(g.pp_ij[:, 1], torch.int64)
        self.pl_p, self.pl_l = t(g.pl_ij[:, 0], torch.int64), t(g.pl_ij[:, 1], torch.int64)
        self.pp_z, self.pp_w, self.pl_z, self.pl_w = t(g.pp_z), t(g.pp_info), t(g.pl_z), t(g.pl_info)
        free = np.ones(3 * self.NP + 2 * self.NL, bool)
        free[: 3 * self.NP] = ~np.repeat(g.fixed, 3)
        self.free = t(free)
        self.dtype, self.device = dt, device

    def residuals(self, poses, lms):
        """Pose-pose errors (EP, 3), pose-landmark errors (EL, 2), and the
        Jacobians' blocks."""
        p = self.precision
        xi, xj = poses[self.pp_i], poses[self.pp_j]
        Rt = _rotT(xi[:, 2])
        d = (xj[:, :2] - xi[:, :2])[:, :, None]
        e_t = mm(Rt, d, p)[:, :, 0] - self.pp_z[:, :2]
        e_pp = torch.cat([e_t, _wrap(xj[:, 2] - xi[:, 2] - self.pp_z[:, 2])[:, None]], 1)
        # d e_t / d theta_i = dRt/dth d; the rotation's derivative is Rt with (c, s) -> (-s, c)
        dRt = torch.stack([torch.stack([-torch.sin(xi[:, 2]), torch.cos(xi[:, 2])], -1),
                           torch.stack([-torch.cos(xi[:, 2]), -torch.sin(xi[:, 2])], -1)], -2)
        Ji = torch.zeros(len(xi), 3, 3, dtype=self.dtype, device=self.device)
        Ji[:, :2, :2] = -Rt
        Ji[:, :2, 2] = mm(dRt, d, p)[:, :, 0]
        Ji[:, 2, 2] = -1.0
        Jj = torch.zeros_like(Ji)
        Jj[:, :2, :2] = Rt
        Jj[:, 2, 2] = 1.0

        xp, l = poses[self.pl_p], lms[self.pl_l]
        Rt = _rotT(xp[:, 2])
        d = (l - xp[:, :2])[:, :, None]
        e_pl = mm(Rt, d, p)[:, :, 0] - self.pl_z
        dRt = torch.stack([torch.stack([-torch.sin(xp[:, 2]), torch.cos(xp[:, 2])], -1),
                           torch.stack([-torch.cos(xp[:, 2]), -torch.sin(xp[:, 2])], -1)], -2)
        Jp = torch.zeros(len(xp), 2, 3, dtype=self.dtype, device=self.device)
        Jp[:, :, :2] = -Rt
        Jp[:, :, 2] = mm(dRt, d, p)[:, :, 0]
        return e_pp, e_pl, (Ji, Jj, Jp, Rt)

    def chi2(self, poses, lms):
        e_pp, e_pl, _ = self.residuals(poses, lms)
        return self._chi2(e_pp, e_pl)

    def _chi2(self, e_pp, e_pl):
        p = self.precision
        c = (mm(self.pp_w, e_pp[:, :, None], p)[:, :, 0] * e_pp).sum()
        return c + (mm(self.pl_w, e_pl[:, :, None], p)[:, :, 0] * e_pl).sum()

    def system(self, poses, lms):
        """Dense H (D, D), gradient b (D,), chi2 at (poses, lms)."""
        p = self.precision
        e_pp, e_pl, (Ji, Jj, Jp, Jl) = self.residuals(poses, lms)
        D = 3 * self.NP + 2 * self.NL
        H = torch.zeros(D, D, dtype=self.dtype, device=self.device)
        b = torch.zeros(D, dtype=self.dtype, device=self.device)
        ar3 = torch.arange(3, device=self.device)
        ar2 = torch.arange(2, device=self.device)

        def add(rows_a, A, rows_b, B, W, e):
            for ra, Ja in ((rows_a, A), (rows_b, B)):
                for rb, Jb in ((rows_a, A), (rows_b, B)):
                    blk = mm(Ja.transpose(1, 2), mm(W, Jb, p), p)
                    H.index_put_((ra[:, :, None], rb[:, None, :]), blk, accumulate=True)
                b.index_put_((ra,), mm(Ja.transpose(1, 2), mm(W, e[:, :, None], p), p)[:, :, 0], accumulate=True)

        add(3 * self.pp_i[:, None] + ar3, Ji, 3 * self.pp_j[:, None] + ar3, Jj, self.pp_w, e_pp)
        add(3 * self.pl_p[:, None] + ar3, Jp, 3 * self.NP + 2 * self.pl_l[:, None] + ar2, Jl, self.pl_w, e_pl)
        return H, b, self._chi2(e_pp, e_pl)


def optimize(prob: Problem, poses, lms, iters: int = 100, lam0: float = 1e-4, tol: float = 1e-10):
    """LM to convergence with dense Cholesky steps and Nielsen's damping
    schedule (the gain ratio of the actual to the model's decrease sets the
    next damping); fixed vertices keep their values. Returns (poses, lms,
    chi2 trace, one entry an iteration)."""
    poses = torch.as_tensor(poses, dtype=prob.dtype, device=prob.device)
    lms = torch.as_tensor(lms, dtype=prob.dtype, device=prob.device)
    free = prob.free
    lam, nu = lam0, 2.0
    H, b, chi2 = prob.system(poses, lms)
    trace = [float(chi2)]
    for _ in range(iters):
        A = H * (free[:, None] * free[None, :])
        diag = A.diagonal()
        diag += lam * diag + (1.0 - free) + 1e-9 * free
        L, info = torch.linalg.cholesky_ex(A)
        del A
        if int(info) != 0:
            lam, nu = lam * nu, nu * 2
            continue
        dx = torch.cholesky_solve((-b * free)[:, None], L)[:, 0]
        del L
        # chi2(x + dx) ~ chi2 + 2 b.dx + dx.H dx; dx is 0 at fixed entries
        model = -(2.0 * torch.dot(b, dx) + torch.dot(dx, mm(H, dx[:, None], prob.precision)[:, 0]))
        new_poses = poses + dx[: 3 * prob.NP].reshape(-1, 3)
        new_poses = torch.cat([new_poses[:, :2], _wrap(new_poses[:, 2:])], 1)
        new_lms = lms + dx[3 * prob.NP:].reshape(-1, 2)
        new_chi2 = float(prob.chi2(new_poses, new_lms))
        if np.isfinite(new_chi2) and new_chi2 < trace[-1]:
            drop = (trace[-1] - new_chi2) / trace[-1]
            # the gain ratio, at most 1 (Nielsen's factor is 1/3 from there on); a model that
            # predicts no decrease where the step made one counts as a good model
            rho = min((trace[-1] - new_chi2) / float(model), 1.0) if float(model) > 0 else 1.0
            poses, lms = new_poses, new_lms
            trace.append(new_chi2)
            lam, nu = max(lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3), 1e-12), 2.0
            if drop < tol:
                break
            H, b, _ = prob.system(poses, lms)
        else:
            trace.append(trace[-1])
            lam, nu = lam * nu, min(nu * 2, 64.0)
            if lam > 1e10:
                break
    return poses, lms, trace
