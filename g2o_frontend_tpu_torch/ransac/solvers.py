"""Closed-form weighted alignment solvers (counterpart of
``g2o_frontend_tpu/ransac/solvers.py``): minimal sets and refinement fits.

Each ``fit_*`` is a weighted least-squares fit over a fixed-size batch of
correspondences. With a one-hot weight over a minimal set it is the
reference's minimal-set solve (``ransac/alignment_*.h``); with inlier
weights it is the refinement step. It returns the transform mapping frame-2
quantities onto frame-1 (``p1 ~ T ⊕ p2``).

Batching replaces ``jax.vmap``: the weights may carry leading hypothesis
dimensions, ``w`` of shape (..., N) against data (N, D), and the fit
returns (..., 3) charts or (..., 4, 4) transforms. Each ``err_*`` takes a
transform with leading dimensions and returns the squared errors
(..., N). Nothing synchronises with the host: the 2x2 and 3x3 solves use
``torch.linalg.solve_ex`` without its error check.
"""
from __future__ import annotations

import torch

from ..utils import lie

_EPS = 1e-9


def _wsum(w):
    return torch.clamp_min(w.sum(-1), _EPS)


def _wmean(w, x):
    """Weighted mean over the correspondence axis: w (..., N), x (N, D)."""
    return (w[..., :, None] * x).sum(-2) / _wsum(w)[..., None]


def _outer_sum(w, a, b):
    """sum_n w_n a_n b_n^T: w (..., N), a (..., N, I), b (..., N, J)."""
    return (w[..., :, None, None] * a[..., :, :, None] * b[..., :, None, :]).sum(-3)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _top_eigvec4(M):
    """Dominant eigenvector of a symmetric PSD-shifted (..., 4, 4) by
    repeated squaring, normalised after each squaring (eight of them)."""
    for _ in range(8):
        M = M @ M
        M = M / torch.clamp_min(torch.sqrt((M * M).sum((-2, -1))), _EPS)[..., None, None]
    q = M @ torch.ones(4, dtype=M.dtype, device=M.device)
    q = (M @ q[..., None])[..., 0]
    return q / torch.clamp_min(lie._norm(q, keepdim=True), _EPS)


def _positive(q):
    return torch.where(q[..., :1] < 0, -q, q)


def _horn_rotation(S):
    """Rotation R maximising tr(R S) (Wahba by Horn's quaternion method)
    from a correlation S (..., 3, 3) of frame-2 against frame-1 vectors."""
    tr = S[..., 0, 0] + S[..., 1, 1] + S[..., 2, 2]
    A = S - S.transpose(-1, -2)
    delta = torch.stack([A[..., 1, 2], A[..., 2, 0], A[..., 0, 1]], -1)
    top = torch.cat([tr[..., None], delta], -1)[..., None, :]
    low = torch.cat([delta[..., :, None], S + S.transpose(-1, -2) - tr[..., None, None] * _eye(3, S)], -1)
    N = torch.cat([top, low], -2)
    # power iteration on N + c I: N's eigenvalues lie within +-2 ||S||
    shift = 2.0 * torch.sqrt((S * S).sum((-2, -1))) + 1e-6
    q = _positive(_top_eigvec4(N + shift[..., None, None] * _eye(4, S)))
    return lie.quat2mat(q[..., 1:] / torch.clamp_min(lie._norm(q, keepdim=True), _EPS))


def _solve(A, b):
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]


def _rotate2(th, v):
    """R(th) v for angles (...,) and vectors (..., N, 2)."""
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


# -- point correspondences -------------------------------------------------------


def fit_se2_points(p1, p2, w):
    """Weighted Horn alignment in 2D: [x, y, th] with p1 ~ R(th) p2 + t.

    p1, p2: (N, 2); w: (..., N). Centroids and the atan2 of the weighted
    cross and dot sums (the 2-point minimal set is the reference Horn2D).
    """
    c1, c2 = _wmean(w, p1), _wmean(w, p2)
    q1, q2 = p1 - c1[..., None, :], p2 - c2[..., None, :]
    s = (w * (q2[..., 0] * q1[..., 1] - q2[..., 1] * q1[..., 0])).sum(-1)
    c = (w * (q2[..., 0] * q1[..., 0] + q2[..., 1] * q1[..., 1])).sum(-1)
    th = torch.atan2(s, c)
    t = c1 - _rotate2(th, c2[..., None, :])[..., 0, :]
    return torch.cat([t, th[..., None]], -1)


def err_se2_points(x, p1, p2):
    """Squared residuals of p1 - (R p2 + t): x (..., 3) -> (..., N)."""
    return ((p1 - lie.se2_apply(x[..., None, :], p2)) ** 2).sum(-1)


def fit_se3_points(p1, p2, w):
    """Weighted Horn alignment in 3D -> (..., 4, 4) with p1 ~ R p2 + t."""
    c1, c2 = _wmean(w, p1), _wmean(w, p2)
    q1, q2 = p1 - c1[..., None, :], p2 - c2[..., None, :]
    R = _horn_rotation(_outer_sum(w, q2, q1))
    return lie._hom(R, c1 - (R @ c2[..., None])[..., 0])


def err_se3_points(T, p1, p2):
    pred = p2 @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
    return ((p1 - pred) ** 2).sum(-1)


# -- pose (vertex) correspondences -----------------------------------------------


def fit_se2_poses(x1, x2, w):
    """SE2 from pose-pose correspondences, T with x1_i ~ T ⊕ x2_i: the
    weighted chart average of T_i = x1_i ⊕ x2_i^{-1} (minimal set 1)."""
    Ti = lie.se2_compose(x1, lie.se2_inverse(x2))
    wsum = _wsum(w)
    t = _wmean(w, Ti[:, :2])
    s = (w * torch.sin(Ti[:, 2])).sum(-1) / wsum
    c = (w * torch.cos(Ti[:, 2])).sum(-1) / wsum
    return torch.cat([t, torch.atan2(s, c)[..., None]], -1)


def err_se2_poses(x, x1, x2):
    """Chart distance of x1 against x ⊕ x2 (rotation weighted 1:1)."""
    d = x1 - lie.se2_compose(x[..., None, :], x2)
    return d[..., 0] ** 2 + d[..., 1] ** 2 + lie.wrap_angle(d[..., 2]) ** 2


def fit_se3_poses(T1, T2, w):
    """SE3 from pose-pose correspondences, T with T1_i ~ T T2_i: the
    weighted mean translation of T_i = T1_i T2_i^{-1}, the rotation from
    the quaternions' M-matrix eigenvector."""
    Ti = T1 @ lie.se3_inverse(T2)
    t = _wmean(w, Ti[:, :3, 3])
    qs = lie.mat2quat_full(Ti[:, :3, :3])  # (N, 4) wxyz
    q = _positive(_top_eigvec4(_outer_sum(w, qs, qs)))
    return lie._hom(lie.quat2mat(q[..., 1:]), t)


def err_se3_poses(T, T1, T2):
    pred = T[..., None, :, :] @ T2
    d = lie.se3_log(lie.se3_inverse(T1) @ pred)
    return (d * d).sum(-1)


# -- 2D lines, [cos a, sin a, rho] with n.p = rho ----------------------------------


def fit_se2_lines(l1, l2, w):
    """SE2 from 2D line correspondences (reference RansacLine2DLinear).

    Under x = (R, t): n1 = R n2 and rho1 = rho2 + n1 . t. The rotation
    comes from the weighted normal average, the translation from the
    weighted 2x2 normal system.
    """
    s = (w * (l2[:, 0] * l1[:, 1] - l2[:, 1] * l1[:, 0])).sum(-1)
    c = (w * (l2[:, 0] * l1[:, 0] + l2[:, 1] * l1[:, 1])).sum(-1)
    th = torch.atan2(s, c)
    n1_pred = _rotate2(th, l2[:, :2])
    A = _outer_sum(w, n1_pred, n1_pred) + _EPS * _eye(2, l1)
    b = ((w * (l1[:, 2] - l2[:, 2]))[..., None] * n1_pred).sum(-2)
    return torch.cat([_solve(A, b), th[..., None]], -1)


def err_se2_lines(x, l1, l2):
    """Normal mismatch plus offset residual of the remapped lines."""
    n_pred = _rotate2(x[..., 2], l2[:, :2])
    rho_pred = l2[:, 2] + (n_pred * x[..., None, :2]).sum(-1)
    return ((l1[:, :2] - n_pred) ** 2).sum(-1) + (l1[:, 2] - rho_pred) ** 2


# -- planes, [nx, ny, nz, d] with n.p = d --------------------------------------------


def fit_se3_planes(pl1, pl2, w):
    """SE3 from plane correspondences (reference AlignmentAlgorithmPlaneLinear).

    Under T = (R, t): n1 = R n2 and d1 = d2 + n1 . t. The rotation is Wahba
    on the normals; the translation solves the weighted 3x3 normal system
    (regularised: it needs three non-parallel planes).
    """
    R = _horn_rotation(_outer_sum(w, pl2[:, :3], pl1[:, :3]))
    n1_pred = pl2[:, :3] @ R.transpose(-1, -2)
    A = _outer_sum(w, n1_pred, n1_pred) + 1e-6 * _eye(3, pl1)
    b = ((w * (pl1[:, 3] - pl2[:, 3]))[..., None] * n1_pred).sum(-2)
    return lie._hom(R, _solve(A, b))


def err_se3_planes(T, pl1, pl2):
    n_pred = pl2[:, :3] @ T[..., :3, :3].transpose(-1, -2)
    d_pred = pl2[:, 3] + (n_pred * T[..., None, :3, 3]).sum(-1)
    return ((pl1[:, :3] - n_pred) ** 2).sum(-1) + (pl1[:, 3] - d_pred) ** 2


# -- 3D lines, direction (3) and a point (3) ------------------------------------------


def fit_se3_lines(l1, l2, w):
    """SE3 from 3D line correspondences (reference alignment_line3d_linear):
    the rotation aligns the directions (Wahba), the translation minimises
    the point-to-line distances of the remapped points,
    sum w (I - d d^T) (R p2 + t - p1) = 0."""
    d1, p1, p2 = l1[:, :3], l1[:, 3:6], l2[:, 3:6]
    R = _horn_rotation(_outer_sum(w, l2[:, :3], d1))
    P = _eye(3, l1) - d1[:, :, None] * d1[:, None, :]  # (N, 3, 3)
    A = (w[..., :, None, None] * P).sum(-3) + 1e-6 * _eye(3, l1)
    r = p1 - p2 @ R.transpose(-1, -2)  # (..., N, 3)
    rhs = (w[..., :, None] * (P @ r[..., None])[..., 0]).sum(-2)
    return lie._hom(R, _solve(A, rhs))


def err_se3_lines(T, l1, l2):
    Rt = T[..., :3, :3].transpose(-1, -2)
    d_pred = l2[:, :3] @ Rt
    p_pred = l2[:, 3:6] @ Rt + T[..., None, :3, 3]
    # direction mismatch (directions assumed consistently signed) plus the
    # predicted point's squared distance to line 1
    dd = ((l1[:, :3] - d_pred) ** 2).sum(-1)
    dp = p_pred - l1[:, 3:6]
    along = (dp * l1[:, :3]).sum(-1)
    return dd + torch.clamp_min((dp * dp).sum(-1) - along**2, 0.0)
