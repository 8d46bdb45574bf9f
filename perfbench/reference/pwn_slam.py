"""Plain reference of PWN SLAM's loop closing and map solve: the matcher's
batch, the closer's gates, the consensus and the SE3 pose-graph optimum,
written from the configuration file's numbers and the published code.

- `match` / `match_batch`: a candidate alignment (`reference/pwn.align`)
  and the image-overlap statistics of ``pwn_matcher_base.cpp:130-182``:
  both clouds rendered in the current view at the matched pose (nearest
  depth a pixel), a pixel of both images counted as nonzero, an inlier
  where the two depths agree within 50 mm, an outlier otherwise; the
  closure's information is the reference's 100 I. A batch is a loop of
  single matches.
- `gates`: the closer's frame gates (``pwn_closer.cpp:117-143``): nonzero
  pixels at least, outliers at most and inliers at least their
  thresholds, and a finite transform and information.
- `consensus`: ``map_closer.cpp:200-430``. Every relation between the
  current partition and another is oriented current -> other; each one, a
  hypothesis, fixes the current partition in the other's frame, and every
  relation is checked against it: its error transform's squared
  translation (squared, as the original compares it with the linear
  threshold) and its rotation angle below the thresholds make it an
  inlier of that hypothesis. A relation gains the hypothesis' inlier count
  when it is an inlier and an outlier time when it is not; once checked
  `consensus_min_times_checked` times it is accepted if its cumulative
  inliers exceed its outlier times, else removed.
- `optimize_se3`: the pose graph's optimum in float64 by dense
  Levenberg-Marquardt with an exact (dense LU) solve each step, in the
  port's chart: poses 4x4, the residual ``log(Z^-1 Xi^-1 Xj)`` as a
  twist [v, w], updates right-multiplied ``X exp(dx)``, the gauge node held
  fixed.
- `lm_se3`: the same graph's solve at a fixed budget, as the map solve
  runs it: `iters` LM iterations, each one step from at most `cg_iters`
  steps of conjugate gradients on ``(H + lam D) dx = -g`` (D the 6x6
  diagonal blocks of H), preconditioned by the exact block-tridiagonal
  part of ``(1 + lam) D + 1e-6 I`` along the odometry chain (relations
  i -> i + 1), and the step kept only if it lowers chi2 (lam halved, at
  least 1e-10; else lam times 4, at most 1e8). Dense matrices throughout;
  the poses, residuals, Jacobians and chi2 in float64 whatever the
  precision, the system and its solve in the precision, the
  preconditioner's exact solve in float64.

It imports nothing of the program under test. Every matrix product of a
match, and of `lm_se3`'s system, goes through `precision.mm` (float32, or
TF32 as the control); the consensus and `optimize_se3` run in float64,
`lm_se3` in the precision it is given (float64 for the judge).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import pwn as ref
from .precision import dtype, mm

# depth agreement (mm) of an image inlier, and the closure's information scale
FRAME_INLIER_DEPTH_MM = 50.0
CLOSURE_INFORMATION = 100.0


class Match(NamedTuple):
    transform: torch.Tensor  # (4, 4) current -> candidate
    information: torch.Tensor  # (6, 6)
    cloud_inliers: torch.Tensor
    image_nonzeros: torch.Tensor
    image_inliers: torch.Tensor
    image_outliers: torch.Tensor


def render(p, valid, cam):
    """Depth image (H, W) of the points p (3, N) of a view: each point at
    its rounded pixel, the nearest depth a pixel, 0 where none lands."""
    H, W = int(cam["rows"]), int(cam["cols"])
    d = p[2]
    u = torch.round(p[0] / d * cam["fx"] + cam["cx"]).to(torch.int64)
    v = torch.round(p[1] / d * cam["fy"] + cam["cy"]).to(torch.int64)
    ok = valid & (d > cam["min_distance"]) & (d < cam["max_distance"]) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    depth = torch.full((H * W,), float("inf"), dtype=p.dtype, device=p.device)
    depth = depth.scatter_reduce(0, (v * W + u)[ok], d[ok], reduce="amin")
    return torch.where(torch.isfinite(depth), depth, 0.0).reshape(H, W)


def overlap(cand: ref.RefCloud, cur: ref.RefCloud, T, cam, precision="float32"):
    """(nonzeros, inliers, outliers) of the candidate and current views at
    T (current -> candidate), in the current view."""
    invT = torch.linalg.inv(T)
    pts = mm(invT[:3, :3], cand.p.reshape(3, -1), precision) + invT[:3, 3:4]
    cand_mm = render(pts, cand.valid.reshape(-1), cam) * 1000.0
    cur_mm = render(cur.p.reshape(3, -1), cur.valid.reshape(-1), cam) * 1000.0
    both = (cand_mm > 0) & (cur_mm > 0)
    nonzeros = both.sum()
    inliers = (both & ((cur_mm - cand_mm).abs() < FRAME_INLIER_DEPTH_MM)).sum()
    return nonzeros, inliers, nonzeros - inliers


def match(cand: ref.RefCloud, cur: ref.RefCloud, cam, guess, acfg, precision="float32") -> Match:
    """One candidate against the current cloud from `guess`."""
    res = ref.align(cand, cur, cam, guess, acfg, precision)
    nz, inl, outl = overlap(cand, cur, res.T, cam, precision)
    info = CLOSURE_INFORMATION * torch.eye(6, dtype=res.T.dtype, device=res.T.device)
    return Match(res.T, info, res.inliers, nz, inl, outl)


def match_batch(cands, cur: ref.RefCloud, cam, guesses, acfg, precision="float32") -> Match:
    """`match` of each candidate in the list `cands` with its guess in
    (K, 4, 4) `guesses`; every field with a leading K axis."""
    return Match(*(torch.stack(x) for x in zip(*(match(c, cur, cam, g, acfg, precision)
                                                 for c, g in zip(cands, guesses)))))


def gates(nonzeros, inliers, outliers, T, info, ccfg) -> bool:
    """Whether a match passes the closer's frame gates."""
    return bool(nonzeros >= ccfg["frame_min_nonzero_threshold"] and outliers <= ccfg["frame_max_outliers_threshold"]
                and inliers >= ccfg["frame_min_inliers_threshold"] and np.isfinite(T).all() and np.isfinite(info).all())


# -- consensus ---------------------------------------------------------------------------------


def _angle(R):
    """The rotation angle of a 3x3 rotation, exact near 0."""
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return abs(math.atan2(s, 0.5 * (np.trace(R) - 1.0)))


def consensus(pose_from, pose_to, transform, from_in_current, counters_before, ccfg):
    """The decisions ("accepted", "removed", "pending") of one consensus
    over R relations: their endpoints' (R, 4, 4) poses, their transforms
    (to -> from), whether each `from` node is in the current partition,
    and their (R, 3) counters before (times checked, cumulative inliers,
    outlier times). float64."""
    R = len(transform)
    tc, to, tr = [], [], []
    for i in range(R):  # orient current -> other
        if from_in_current[i]:
            tc.append(pose_from[i])
            to.append(pose_to[i])
            tr.append(np.linalg.inv(transform[i]))
        else:
            tc.append(pose_to[i])
            to.append(pose_from[i])
            tr.append(np.asarray(transform[i], np.float64))
    checked = [int(c[0]) + 1 for c in counters_before]
    cum_in = [int(c[1]) for c in counters_before]
    cum_out = [int(c[2]) for c in counters_before]
    t_thr = ccfg["consensus_inlier_translational_threshold"]
    r_thr = ccfg["consensus_inlier_rotational_threshold"]
    for i in range(R):
        fix = to[i] @ tr[i] @ np.linalg.inv(tc[i])  # the current partition in the other's frame
        inlier = []
        for j in range(R):
            err = np.linalg.inv(tr[j]) @ np.linalg.inv(to[j]) @ fix @ tc[j]
            inlier.append(float(err[:3, 3] @ err[:3, 3]) < t_thr and _angle(err[:3, :3]) < r_thr)
        n_in = sum(inlier)
        for j in range(R):
            if inlier[j]:
                cum_in[j] += n_in
            else:
                cum_out[j] += 1
    out = []
    for j in range(R):
        if checked[j] < ccfg["consensus_min_times_checked"]:
            out.append("pending")
        else:
            out.append("accepted" if cum_in[j] > cum_out[j] else "removed")
    return out


# -- the SE3 pose graph -----------------------------------------------------------------------


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1), torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp(xi):
    """Twist (..., 6) [v, w] -> (..., 4, 4): Rodrigues and the left Jacobian V."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2 + 1e-300)
    small = th2 < 1e-10
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th2 + 1e-300))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th2 * th + 1e-300))
    W = _skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    Rm = eye + a * W + b * (W @ W)
    V = eye + b * W + c * (W @ W)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = Rm
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def _log(T):
    """(..., 4, 4) -> twist (..., 6) [V^-1 t, w]."""
    Rm, t = T[..., :3, :3], T[..., :3, 3]
    s = 0.5 * torch.stack([Rm[..., 2, 1] - Rm[..., 1, 2], Rm[..., 0, 2] - Rm[..., 2, 0],
                           Rm[..., 1, 0] - Rm[..., 0, 1]], -1)
    cos = 0.5 * (Rm.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    sin = torch.sqrt((s * s).sum(-1) + 1e-300)
    th = torch.atan2(sin, cos)
    w = torch.where((th < 1e-5)[..., None], (1.0 + th * th / 6.0)[..., None] * s, (th / sin)[..., None] * s)
    th2 = (w * w).sum(-1)[..., None, None]
    thn = torch.sqrt(th2 + 1e-300)
    d = torch.where(th2 < 1e-8, 1.0 / 12.0 + th2 / 720.0,
                    (1.0 - thn * torch.sin(thn) / (2.0 * (1.0 - torch.cos(thn)) + 1e-300)) / (th2 + 1e-300))
    W = _skew(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + d * (W @ W)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def _inv(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _residual(dxi, dxj, Ti, Tj, Zinv):
    return _log(Zinv @ _inv(Ti @ _exp(dxi)) @ (Tj @ _exp(dxj)))


def chi2_se3(poses, edges, transforms, information):
    """sum e^T Omega e over the edges at `poses` (N, 4, 4), float64."""
    dev = poses.device
    ij = torch.as_tensor(edges, device=dev)
    Zinv = _inv(torch.as_tensor(transforms, dtype=torch.float64, device=dev))
    zero = torch.zeros(6, dtype=torch.float64, device=dev)
    e = _residual(zero, zero, poses[ij[:, 0]], poses[ij[:, 1]], Zinv)
    Om = torch.as_tensor(information, dtype=torch.float64, device=dev)
    return float(torch.einsum("ki,kij,kj->", e, Om, e))


def optimize_se3(poses, edges, transforms, information, gauge=0, iters=100, lam0=1e-4, tol=1e-14, device="cpu"):
    """The optimum of the pose graph from `poses` (N, 4, 4) and the edges
    (E, 2) with their (E, 4, 4) transforms and (E, 6, 6) information, the
    node `gauge` held fixed: (poses (N, 4, 4) float64 tensor, chi2, LM
    iterations run). Stops when a step lowers chi2 by less than `tol` of it."""
    X = torch.as_tensor(np.asarray(poses), dtype=torch.float64, device=device).clone()
    N = X.shape[0]
    ij = torch.as_tensor(np.asarray(edges), device=device)
    Zinv = _inv(torch.as_tensor(np.asarray(transforms), dtype=torch.float64, device=device))
    Om = torch.as_tensor(np.asarray(information), dtype=torch.float64, device=device)
    zero = torch.zeros(6, dtype=torch.float64, device=device)
    free = torch.ones(6 * N, dtype=torch.bool, device=device)
    free[6 * gauge:6 * gauge + 6] = False
    idx = torch.arange(6, device=device)

    def chi2(X):
        e = _residual(zero, zero, X[ij[:, 0]], X[ij[:, 1]], Zinv)
        return torch.einsum("ki,kij,kj->", e, Om, e)

    lam, cost, k = lam0, chi2(X), 0
    for k in range(1, iters + 1):
        Ti, Tj = X[ij[:, 0]], X[ij[:, 1]]
        e = _residual(zero, zero, Ti, Tj, Zinv)
        Ji = torch.func.jacfwd(lambda d: _residual(d, zero, Ti, Tj, Zinv))(zero)
        Jj = torch.func.jacfwd(lambda d: _residual(zero, d, Ti, Tj, Zinv))(zero)
        H = torch.zeros(6 * N, 6 * N, dtype=torch.float64, device=device)
        g = torch.zeros(6 * N, dtype=torch.float64, device=device)
        blocks = {"i": (ij[:, 0], Ji), "j": (ij[:, 1], Jj)}
        for a, (na, Ja) in blocks.items():
            g.index_add_(0, (6 * na[:, None] + idx).reshape(-1), torch.einsum("kdi,kde,ke->ki", Ja, Om, e).reshape(-1))
            for b, (nb, Jb) in blocks.items():
                rows = (6 * na[:, None, None] + idx[:, None]).expand(-1, 6, 6)
                cols = (6 * nb[:, None, None] + idx[None, :]).expand(-1, 6, 6)
                H.index_put_((rows.reshape(-1), cols.reshape(-1)),
                             torch.einsum("kdi,kde,kej->kij", Ja, Om, Jb).reshape(-1), accumulate=True)
        Hf = H[free][:, free]
        while True:
            A = Hf + lam * torch.diag(torch.diagonal(Hf))
            dx = torch.zeros(6 * N, dtype=torch.float64, device=device)
            dx[free] = torch.linalg.solve(A, -g[free])
            Xn = X @ _exp(dx.reshape(N, 6))
            new = chi2(Xn)
            if new < cost:
                break
            lam *= 4.0
            if lam > 1e12:
                return X, float(cost), k
        done = float(cost - new) <= tol * float(cost)
        X, cost, lam = Xn, new, max(lam * 0.5, 1e-12)
        if done:
            break
    return X, float(cost), k


def lm_se3(poses, edges, transforms, information, gauge=0, iters=5, cg_iters=40, lam0=1e-4, precision="float64",
           device="cpu"):
    """The map solve's result at its own budget (the module's docstring):
    (poses (N, 4, 4) tensor, the chi2 after each iteration)."""
    dt, f64 = dtype(precision), torch.float64
    X = torch.as_tensor(np.asarray(poses), dtype=f64, device=device).clone()
    N = X.shape[0]
    ij = torch.as_tensor(np.asarray(edges), device=device).reshape(-1, 2)
    Zinv = _inv(torch.as_tensor(np.asarray(transforms), dtype=f64, device=device))
    Om64 = torch.as_tensor(np.asarray(information), dtype=f64, device=device)
    Om = Om64.to(dt)
    zero = torch.zeros(6, dtype=f64, device=device)
    free = torch.ones(N, dtype=dt, device=device)
    free[gauge] = 0.0
    fr = free.repeat_interleave(6)
    eye6 = torch.eye(6, dtype=dt, device=device)
    rows = 6 * torch.arange(N, device=device)[:, None] + torch.arange(6, device=device)
    chain = ij[:, 1] == ij[:, 0] + 1

    def chi2(X):
        e = _residual(zero, zero, X[ij[:, 0]], X[ij[:, 1]], Zinv)
        return torch.einsum("ki,kij,kj->", e, Om64, e)

    def put(M, a, b, blocks):
        r = rows[a][:, :, None].expand(-1, 6, 6)
        c = rows[b][:, None, :].expand(-1, 6, 6)
        M.index_put_((r.reshape(-1), c.reshape(-1)), blocks.reshape(-1), accumulate=True)

    lam, cost, trace = lam0, chi2(X), []
    for _ in range(iters):
        Ti, Tj = X[ij[:, 0]], X[ij[:, 1]]
        e = _residual(zero, zero, Ti, Tj, Zinv).to(dt)
        J = {"i": torch.func.jacfwd(lambda d: _residual(d, zero, Ti, Tj, Zinv))(zero).to(dt),
             "j": torch.func.jacfwd(lambda d: _residual(zero, d, Ti, Tj, Zinv))(zero).to(dt)}
        node = {"i": ij[:, 0], "j": ij[:, 1]}
        We = mm(Om, e[..., None], precision)
        H = torch.zeros(6 * N, 6 * N, dtype=dt, device=device)
        g = torch.zeros(6 * N, dtype=dt, device=device)
        off = torch.zeros(N, 6, 6, dtype=dt, device=device)  # the chain's blocks (n, n + 1)
        for a in "ij":
            g.index_add_(0, rows[node[a]].reshape(-1), mm(J[a].transpose(-1, -2), We, precision).reshape(-1))
            for b in "ij":
                blocks = mm(J[a].transpose(-1, -2), mm(Om, J[b], precision), precision)
                put(H, node[a], node[b], blocks)
                if a == "i" and b == "j":
                    off.index_add_(0, ij[chain, 0], blocks[chain])
        D = H.reshape(N, 6, N, 6).diagonal(dim1=0, dim2=2).permute(2, 0, 1)  # (N, 6, 6)
        BD = torch.block_diag(*D)
        A = (H + lam * BD) * fr[:, None] * fr[None, :] + torch.diag(1.0 - fr)
        M = torch.block_diag(*torch.where(free[:, None, None] > 0, (1.0 + lam) * D + 1e-6 * eye6, eye6))
        off = off * (free * torch.cat([free[1:], free.new_zeros(1)]))[:, None, None]
        n = torch.arange(N - 1, device=device)
        put(M, n, n + 1, off[:-1])
        put(M, n + 1, n, off[:-1].transpose(-1, -2))
        L, info = torch.linalg.cholesky_ex(M.to(f64))
        if int(info) == 0:
            def pre(r):
                return torch.cholesky_solve(r.to(f64)[:, None], L)[:, 0].to(dt)
        else:  # blocks rounded below float64 may leave M short of positive definite
            LU, piv = torch.linalg.lu_factor(M.to(f64))

            def pre(r):
                return torch.linalg.lu_solve(LU, piv, r.to(f64)[:, None])[:, 0].to(dt)

        b = -g * fr
        x, r = torch.zeros_like(b), b.clone()
        z = pre(r)
        p, rz = z, r @ z
        tol2 = 1e-16 * torch.clamp_min(rz, 1e-30)
        for _ in range(cg_iters):
            if not rz > tol2:
                break
            hp = mm(A, p[:, None], precision)[:, 0]
            php = p @ hp
            alpha = rz / php if php > 0 else torch.zeros_like(rz)
            x, r = x + alpha * p, r - alpha * hp
            z = pre(r)
            rz_new = r @ z
            p, rz = z + rz_new / (rz if rz > 0 else 1e-30) * p, rz_new
        Xn = X @ _exp((x * fr).reshape(N, 6).to(f64))
        new = chi2(Xn)
        if new < cost:
            X, cost, lam = Xn, new, max(lam * 0.5, 1e-10)
        else:
            lam = min(lam * 4.0, 1e8)
        trace.append(float(cost))
    return X, trace
