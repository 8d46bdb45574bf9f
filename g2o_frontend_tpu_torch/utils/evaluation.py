"""Trajectory evaluation: absolute and relative trajectory error
(counterpart of ``g2o_frontend_tpu/utils/evaluation.py``).

Stamps are associated as in the TUM benchmark; for ATE the estimate is
aligned to the ground truth by the closed-form Horn/Umeyama rigid fit in
float64 (the JAX package takes a float32 power-iteration Horn fit from its
RANSAC solvers), then the position RMSE is reported. `rpe` is the
translational relative pose error over an index delta, in float64 numpy as
the JAX package's. `ate_xy`, the planar ATE of the 2D SLAM configurations,
aligns by the RANSAC solvers' float32 Horn2D fit, as the JAX package's
does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.tum import associate


def pose7_to_T(p):
    """TUM pose ``[x y z qx qy qz qw]`` -> 4x4 float64 transform (the
    quaternion normalised)."""
    T = np.eye(4)
    q = np.asarray(p[3:7], float)
    w, x, y, z = q[3], q[0], q[1], q[2]
    n = np.sqrt(w * w + x * x + y * y + z * z) + 1e-12
    w, x, y, z = w / n, x / n, y / n, z / n
    T[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    T[:3, 3] = p[:3]
    return T


def fit_rigid(src, dst):
    """Least-squares rigid transform (4x4, float64) with dst ~ R src + t
    (Umeyama's SVD solution, reflection-corrected)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    S = (dst - mu_d).T @ (src - mu_s)
    U, _, Vt = np.linalg.svd(S)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt)) or 1.0])
    T = np.eye(4)
    T[:3, :3] = U @ D @ Vt
    T[:3, 3] = mu_d - T[:3, :3] @ mu_s
    return T


def ate(ts_est, poses_est7, ts_gt, poses_gt7, max_difference=0.02, align=True):
    """Absolute trajectory error of TUM poses ``[x y z qx qy qz qw]``.

    Returns a dict with rmse/mean/median/std/max (meters) and the number of
    associated pairs; `align=True` rigidly aligns the estimate to the ground
    truth first (the TUM protocol).
    """
    pairs = associate(ts_est, ts_gt, max_difference)
    if not pairs:
        return {"rmse": np.inf, "pairs": 0}
    P_est = np.asarray(poses_est7, np.float64)[[a for a, _ in pairs], :3]
    P_gt = np.asarray(poses_gt7, np.float64)[[b for _, b in pairs], :3]
    if align and len(pairs) >= 3:
        T = fit_rigid(P_est, P_gt)
        P_est = P_est @ T[:3, :3].T + T[:3, 3]
    err = np.linalg.norm(P_est - P_gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "max": float(err.max()),
        "pairs": len(pairs),
    }


def rpe(ts_est, poses_est7, ts_gt, poses_gt7, delta=1, max_difference=0.02):
    """Relative pose error over index `delta` (translational part): rmse,
    mean and the number of associated pairs."""
    pairs = associate(ts_est, ts_gt, max_difference)
    if len(pairs) <= delta:
        return {"rmse": np.inf, "pairs": 0}
    errs = []
    for k in range(len(pairs) - delta):
        ia0, ib0 = pairs[k]
        ia1, ib1 = pairs[k + delta]
        Te = np.linalg.inv(pose7_to_T(poses_est7[ia0])) @ pose7_to_T(poses_est7[ia1])
        Tg = np.linalg.inv(pose7_to_T(poses_gt7[ib0])) @ pose7_to_T(poses_gt7[ib1])
        errs.append(np.linalg.norm((np.linalg.inv(Tg) @ Te)[:3, 3]))
    errs = np.asarray(errs)
    return {
        "rmse": float(np.sqrt(np.mean(errs**2))),
        "mean": float(errs.mean()),
        "pairs": len(pairs),
    }


def ate_xy(est_xy, gt_xy, align=True):
    """2D ATE for the planar SLAM configs (datasets/2D evaluation): the
    estimate aligned to the ground truth by `fit_se2_points` in float32."""
    from ..ransac.solvers import fit_se2_points

    est = np.asarray(est_xy, np.float32)
    gt = np.asarray(gt_xy, np.float32)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 2:
        x = fit_se2_points(torch.as_tensor(gt), torch.as_tensor(est), torch.ones(n)).numpy()
        c, s = np.cos(x[2]), np.sin(x[2])
        est = est @ np.array([[c, -s], [s, c]]).T + x[:2]
    err = np.linalg.norm(est - gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mean": float(err.mean()),
        "max": float(err.max()),
        "pairs": n,
    }
