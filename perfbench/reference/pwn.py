"""Plain PyTorch reference of PWN odometry: depth -> point-with-normal
cloud, the projective-association Gauss-Newton aligner and the keyframe
tracker's step, written from the configuration file's numbers.

It follows the published algorithm as the PWN reference code runs it
(``DepthImageConverter``, ``Aligner``, ``PwnTracker``): window moments from
integral images over radius levels, a closed-form 3x3 eigendecomposition,
point and normal information matrices; each Gauss-Newton system from the
projective gather with the four correspondence gates and the robust
point+normal error, damping 1001 I, the quaternion chart and an unscented
remap of the information at the optimum. The converter keeps the order of
the float32 operations of the original code, whose float32 moments lose
digits at range, so that a sound program compares bit for bit there.

Every matrix product goes through `precision.mm`, so the same code runs in
the stated float32 or, as the control, in TF32. It imports nothing of the
program under test.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .precision import dtype, mm


class RefCloud(NamedTuple):
    """Per-pixel cloud, channel-planar: p (3, H, W), n (3, H, W), curv
    (H, W), op / on (6, H, W) upper triangles xx xy xz yy yz zz, valid."""

    p: torch.Tensor
    n: torch.Tensor
    curv: torch.Tensor
    op: torch.Tensor
    on: torch.Tensor
    valid: torch.Tensor


class RefAlign(NamedTuple):
    T: torch.Tensor
    omega: torch.Tensor
    inliers: torch.Tensor
    chi2: torch.Tensor
    translational_ratio: torch.Tensor
    rotational_ratio: torch.Tensor


# -- converter -----------------------------------------------------------------------------


def radius_levels(ccfg):
    lo, hi, n = int(ccfg["min_image_radius"]), int(ccfg["max_image_radius"]), int(ccfg["n_radius_levels"])
    n = min(n, hi - lo + 1)
    return sorted({int(round(lo * (hi / lo) ** (k / max(n - 1, 1)))) for k in range(n)})


def _window_sums(I, r, H, W):
    Ip = F.pad(I[None], (r, r, r, r), mode="replicate")[0]
    s = 2 * r + 1
    return Ip[:, s:s + H, s:s + W] - Ip[:, 0:H, s:s + W] - Ip[:, s:s + H, 0:W] + Ip[:, 0:H, 0:W]


def _eigvals(xx, xy, xz, yy, yz, zz):
    eps = 1e-12
    q = (xx + yy + zz) / 3.0
    b00, b11, b22 = xx - q, yy - q, zz - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (xy * xy + xz * xz + yz * yz) / 3.0
    p = torch.sqrt(p2 + eps)
    det = b00 * (b11 * b22 - yz * yz) - xy * (xy * b22 - yz * xz) + xz * (xy * yz - b11 * xz)
    r = torch.clamp(det / (2.0 * p * p * p + eps), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    hi = q + 2.0 * p * torch.cos(phi)
    lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lo, 3.0 * q - hi - lo, hi


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _null_direction(o, lam, fallback):
    """Unit null direction of (A - lam I): the largest cross product of two rows."""
    xx, xy, xz, yy, yz, zz = o
    r0, r1, r2 = (xx - lam, xy, xz), (xy, yy - lam, yz), (xz, yz, zz - lam)
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = _dot(c01, c01), _dot(c02, c02), _dot(c12, c12)
    v = tuple(torch.where(n01 >= n02, a, b) for a, b in zip(c01, c02))
    v = tuple(torch.where(n12 > torch.maximum(n01, n02), a, b) for a, b in zip(c12, v))
    nrm = torch.sqrt(_dot(v, v))
    inv = 1.0 / torch.clamp_min(nrm, 1e-12)
    return tuple(torch.where(nrm > 1e-10, vk * inv, fk) for vk, fk in zip(v, fallback))


def _eigh(o):
    """Ascending eigenvalues and a right-handed eigenvector frame of sym6
    planes `o`."""
    lam = _eigvals(*o)
    z, one = torch.zeros_like(o[0]), torch.ones_like(o[0])
    ez, ex = (z, z, one), (one, z, z)
    v0 = _null_direction(o, lam[0], ez)
    v1 = _null_direction(o, lam[1], ex)
    d = _dot(v1, v0)
    v1 = tuple(v1[k] - d * v0[k] for k in range(3))
    n1 = torch.sqrt(_dot(v1, v1))
    alt = _cross(v0, ez)
    alt = tuple(torch.where(torch.sqrt(_dot(alt, alt)) > 1e-6, a, b) for a, b in zip(alt, _cross(v0, ex)))
    alt_inv = 1.0 / torch.clamp_min(torch.sqrt(_dot(alt, alt)), 1e-12)
    alt = tuple(a * alt_inv for a in alt)
    inv1 = 1.0 / torch.clamp_min(n1, 1e-12)
    v1 = tuple(torch.where(n1 > 1e-6, v1[k] * inv1, alt[k]) for k in range(3))
    return lam, (v0, v1, _cross(v0, v1))


def _upper(M):
    """(N, 3, 3) -> (6, N) upper triangles."""
    return torch.stack([M[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))])


def convert(depth, cam, ccfg, precision="float32"):
    """(H, W) depth in meters -> RefCloud (the DepthImageConverter)."""
    H, W = int(cam["rows"]), int(cam["cols"])
    depth = depth.to(dtype(precision))
    kw = dict(dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, **kw)[:, None]
    u = torch.arange(W, **kw)[None, :]
    z = depth
    valid = (z > cam["min_distance"]) & (z < cam["max_distance"]) & torch.isfinite(z)
    x = (u - cam["cx"]) / cam["fx"] * z
    y = (v - cam["cy"]) / cam["fy"] * z
    p = torch.where(valid[None], torch.stack([x.expand(H, W), y.expand(H, W), z]), 0.0)

    r = torch.where(depth > cam["min_distance"],
                    torch.ceil(ccfg["world_radius"] * cam["fx"] / torch.clamp_min(depth, 1e-6)), 0.0).to(torch.int32)
    r = torch.clamp(r, int(ccfg["min_image_radius"]), int(ccfg["max_image_radius"]))

    m = valid.to(p.dtype)
    pm = p * m[None]
    acc = torch.stack([m, pm[0], pm[1], pm[2], pm[0] * p[0], pm[0] * p[1], pm[0] * p[2], pm[1] * p[1],
                       pm[1] * p[2], pm[2] * p[2]])
    integral = F.pad(torch.cumsum(torch.cumsum(acc, 1), 2), (1, 0, 1, 0))
    levels = radius_levels(ccfg)
    sums = [_window_sums(integral, lev, H, W) for lev in levels]
    S = sums[-1]
    for lev, s in zip(levels[-2::-1], sums[-2::-1]):
        S = torch.where((r <= lev)[None], s, S)
    n = S[0]
    n_safe = torch.clamp_min(n, 1.0)
    mean = S[1:4] / n_safe[None]
    m0, m1, m2 = mean[0], mean[1], mean[2]
    cov = (S[4] / n_safe - m0 * m0, S[5] / n_safe - m0 * m1, S[6] / n_safe - m0 * m2,
           S[7] / n_safe - m1 * m1, S[8] / n_safe - m1 * m2, S[9] / n_safe - m2 * m2)
    enough = valid & (n >= ccfg["min_points"])

    lam, V = _eigh(cov)
    lam = tuple(torch.clamp_min(l, 0.0) for l in lam)
    v0 = V[0]
    flip = v0[0] * p[0] + v0[1] * p[1] + v0[2] * p[2] > 0
    sgn = torch.where(flip, -1.0, 1.0)
    curv = lam[0] / torch.clamp_min(lam[0] + lam[1] + lam[2], 1e-12)
    flat = curv < ccfg["curvature_threshold"]
    hn = (enough & flat).to(p.dtype)
    normal = torch.stack([hn * (sgn * v0[k]) for k in range(3)])

    # point information U diag U^T: flat where the surface is flat, else 1/eigenvalues
    inv_lam = [1.0 / torch.clamp_min(l, 1e-7) for l in lam]
    diag = torch.stack([torch.where(flat, ccfg["point_flat_info"][k], inv_lam[k]) for k in range(3)], -1)
    U = torch.stack([torch.stack(V[k], -1) for k in range(3)], -1).reshape(-1, 3, 3)  # columns: eigenvectors
    op = hn.reshape(1, -1) * _upper(mm(U * diag.reshape(-1, 1, 3), U.transpose(1, 2), precision))
    zero = torch.zeros_like(curv)
    nf, nn = ccfg["normal_flat_info"], ccfg["normal_nonflat_info"]
    on_d = [torch.where(flat, nf[k] * torch.ones_like(curv), nn[k] * torch.ones_like(curv)) * hn for k in range(3)]
    return RefCloud(p, normal, torch.where(enough, curv, 1.0), op.reshape(6, H, W),
                    torch.stack([on_d[0], zero, zero, on_d[1], zero, on_d[2]]), valid)


# -- SE(3) in the quaternion chart --------------------------------------------------------------


def v2t(v, precision):
    """[t, qx qy qz] -> (4, 4), qw = sqrt(1 - |q|^2)."""
    qx, qy, qz = v[..., 3], v[..., 4], v[..., 5]
    qw = torch.sqrt(torch.clamp_min(1.0 - (qx * qx + qy * qy + qz * qz), 0.0))
    R = torch.stack([
        torch.stack([qw * qw + qx * qx - qy * qy - qz * qz, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qz * qw), qw * qw - qx * qx + qy * qy - qz * qz, 2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), qw * qw - qx * qx - qy * qy + qz * qz], -1),
    ], -2)
    return _hom(R, v[..., :3])


def _hom(R, t):
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def t2v(T):
    """(4, 4) -> [t, q_xyz] with qw >= 0 (Shepperd's method)."""
    R = T[..., :3, :3]
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    one = torch.ones_like(tr)
    cands = torch.stack([
        torch.stack([one + tr, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]], -1),
        torch.stack([m[2][1] - m[1][2], one + m[0][0] - m[1][1] - m[2][2], m[0][1] + m[1][0], m[0][2] + m[2][0]], -1),
        torch.stack([m[0][2] - m[2][0], m[0][1] + m[1][0], one - m[0][0] + m[1][1] - m[2][2], m[1][2] + m[2][1]], -1),
        torch.stack([m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1], one - m[0][0] - m[1][1] + m[2][2]], -1),
    ], -2)
    pivots = torch.stack([one + tr, one + m[0][0] - m[1][1] - m[2][2], one - m[0][0] + m[1][1] - m[2][2],
                          one - m[0][0] - m[1][1] + m[2][2]], -1)
    q = torch.gather(cands, -2, torch.argmax(pivots, -1)[..., None, None].expand(pivots.shape[:-1] + (1, 4)))[..., 0, :]
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
    q = torch.where(q[..., :1] < 0, -q, q)
    return torch.cat([T[..., :3, 3], q[..., 1:]], -1)


def inverse(T, precision):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _hom(Rt, -mm(Rt, T[..., :3, 3:4], precision)[..., 0])


# -- aligner -------------------------------------------------------------------------------


def _sym_apply(o, v):
    xx, xy, xz, yy, yz, zz = o
    return (xx * v[0] + xy * v[1] + xz * v[2], xy * v[0] + yy * v[1] + yz * v[2], xz * v[0] + yz * v[1] + zz * v[2])


def system(ref: RefCloud, cur: RefCloud, invT, cam, acfg, precision="float32"):
    """One Gauss-Newton system at invT (reference -> current): H (6, 6),
    b (6,), robust chi2, inliers. Every current pixel is projected into
    the reference image, the reference point there is fetched, and the
    pair is kept if it passes the four gates."""
    H_, W_ = int(cam["rows"]), int(cam["cols"])
    R, t = invT[:3, :3], invT[:3, 3]
    Rinv = R.T
    tinv = -mm(Rinv, t[:, None], precision)[:, 0]
    q = mm(Rinv, cur.p.reshape(3, -1), precision) + tinv[:, None]
    d = q[2]
    safe = torch.where(d == 0, 1e-9, d)
    u = torch.round(q[0] / safe * cam["fx"] + cam["cx"]).to(torch.int64)
    v = torch.round(q[1] / safe * cam["fy"] + cam["cy"]).to(torch.int64)
    inside = (cur.valid.reshape(-1) & (d > cam["min_distance"]) & (d < cam["max_distance"])
              & (u >= 0) & (u < W_) & (v >= 0) & (v < H_))
    idx = torch.clamp(v, 0, H_ - 1) * W_ + torch.clamp(u, 0, W_ - 1)
    rp = ref.p.reshape(3, -1)[:, idx]
    rn = ref.n.reshape(3, -1)[:, idx]
    rcurv = ref.curv.reshape(-1)[idx]
    rvalid = ref.valid.reshape(-1)[idx]
    p = mm(R, rp, precision) + t[:, None]  # the reference pair in the current frame
    n = mm(R, rn, precision)
    cp, cn, ccurv = cur.p.reshape(3, -1), cur.n.reshape(3, -1), cur.curv.reshape(-1)
    thr = acfg["flat_curvature_threshold"]
    ratio = (torch.clamp_min(rcurv, thr) + 1e-5) / (torch.clamp_min(ccurv, thr) + 1e-5)
    mask = (inside & rvalid & ((cn * cn).sum(0) > 0) & ((rn * rn).sum(0) > 0)
            & ((cn * n).sum(0) >= acfg["inlier_normal_angular_threshold"])
            & (((cp - p) ** 2).sum(0) <= acfg["inlier_distance_threshold"] ** 2)
            & (ratio >= 1.0 / acfg["inlier_curvature_ratio_threshold"])
            & (ratio <= acfg["inlier_curvature_ratio_threshold"]))

    op, on = cur.op.reshape(6, -1), cur.on.reshape(6, -1)
    ep, en = tuple(p - cp), tuple(n - cn)
    wp, wn = _sym_apply(op, ep), _sym_apply(on, en)
    chi2 = _dot(ep, wp) + _dot(en, wn)
    max_chi2 = acfg["inlier_max_chi2"]
    kscale = torch.where(chi2 > max_chi2, torch.sqrt(max_chi2 / torch.clamp_min(chi2, 1e-12)), 1.0)
    m = mask.to(p.dtype)
    mk = m * kscale
    # the jacobian's rotational columns in the quaternion chart: -2 [p]x and -2 [n]x
    zero = torch.zeros_like(p[0])
    s = [(zero, -2 * p[2], 2 * p[1]), (2 * p[2], zero, -2 * p[0]), (-2 * p[1], 2 * p[0], zero)]
    tn = [(zero, -2 * n[2], 2 * n[1]), (2 * n[2], zero, -2 * n[0]), (-2 * n[1], 2 * n[0], zero)]
    c = [_sym_apply(op, sj) for sj in s]
    dd = [_sym_apply(on, tj) for tj in tn]
    Htt = [[(m * op[_SYM[3 * i + j]]).sum() for j in range(3)] for i in range(3)]
    Htr = [[(m * c[j][i]).sum() for j in range(3)] for i in range(3)]
    Hrr = [[(m * (_dot(s[i], c[j]) + _dot(tn[i], dd[j]))).sum() for j in range(3)] for i in range(3)]
    bt = [(mk * wp[k]).sum() for k in range(3)]
    br = [2 * (mk * (p[(k + 1) % 3] * wp[(k + 2) % 3] - p[(k + 2) % 3] * wp[(k + 1) % 3]
                     + n[(k + 1) % 3] * wn[(k + 2) % 3] - n[(k + 2) % 3] * wn[(k + 1) % 3])).sum() for k in range(3)]
    Hm = torch.stack([torch.stack(Htt[i] + Htr[i]) for i in range(3)]
                     + [torch.stack([Htr[j][i] for j in range(3)] + [Hrr[min(i, j)][max(i, j)] for j in range(3)])
                        for i in range(3)])
    return Hm, torch.stack(bt + br), (mk * chi2).sum(), mask.sum().to(torch.int32)


_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]


def align(ref: RefCloud, cur: RefCloud, cam, guess, acfg, precision="float32"):
    """T (current -> reference) from `guess`, with its information and
    the statistics at the optimum (the Aligner)."""
    dt = dtype(precision)
    dev = cur.p.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    invT = inverse(torch.as_tensor(guess, dtype=dt, device=dev), precision)
    for _ in range(int(acfg["outer_iterations"])):
        for _ in range(int(acfg["inner_iterations"])):
            H, b, _, _ = system(ref, cur, invT, cam, acfg, precision)
            dx = torch.linalg.solve(H + acfg["damping"] * eye6, -b)
            invT = mm(v2t(dx, precision), invT, precision)
        invT = v2t(t2v(invT), precision)
    T = inverse(invT, precision)
    H, _, chi2, inliers = system(ref, cur, invT, cam, acfg, precision)
    return _stats(T, H, chi2, inliers, precision)


def _stats(T, H, chi2, inliers, precision):
    """The unscented remap of N(0, (H + I)^-1) through p -> t2v(T v2t(p)^-1)
    gives the information of T; the eigenvalue ratios of its blocks."""
    dt, dev = T.dtype, T.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    sigma0 = torch.linalg.solve(H + eye6, eye6)
    alpha, beta, dim = 1e-3, 2.0, 6
    lam = alpha * alpha * dim
    L = torch.linalg.cholesky_ex((dim + lam) * sigma0 + 1e-9 * eye6).L  # a failed factor gives NaNs, and fails
    pts = torch.cat([torch.zeros(1, 6, dtype=dt, device=dev), L.T, -L.T])
    samples = t2v(mm(T[None], inverse(v2t(pts, precision), precision), precision))
    w = torch.full((13,), 1.0 / (2.0 * (dim + lam)), dtype=dt, device=dev)
    wc = w.clone()
    w[0] = lam / (dim + lam)
    wc[0] = lam / (dim + lam) + (1.0 - alpha * alpha + beta)
    mean = (w[:, None] * samples).sum(0)
    delta = samples - mean
    sigma = mm((wc[:, None] * delta).T, delta, precision)
    omega = torch.linalg.solve(sigma + 1e-9 * eye6, eye6)
    st = torch.linalg.eigvalsh(omega[:3, :3].double())
    sr = torch.linalg.eigvalsh(omega[3:, 3:].double())
    return RefAlign(T, omega, inliers, chi2, (st[2] / st[0].clamp_min(1e-12)).to(dt),
                    (sr[2] / sr[0].clamp_min(1e-12)).to(dt))


# -- the tracker's step, in float64 on the host as the tracker keeps poses --------------------------


def renormalize(T):
    U, _, Vt = np.linalg.svd(T[:3, :3])
    T = T.copy()
    T[:3, :3] = U @ Vt
    return T


def relation_information(omega):
    """The keyframe relation's information from an alignment's omega:
    symmetrised and scaled so that its largest entry is at most 1e4."""
    info = np.asarray(omega, np.float64)
    if not np.isfinite(info).all():
        return np.eye(6) * 100.0
    info = 0.5 * (info + info.T)
    mx = np.abs(info).max()
    return info * (1e4 / mx) if mx > 1e4 else info
