"""Synthetic plane-scene depth rendering (counterpart of
``g2o_frontend_tpu/utils/synth.py``): analytic ray casting with exact
ground truth, in numpy, returned as a float32 tensor on the asked device.
Also the 640x480 bench pair of ``bench.py`` and the poses of its candidate
batch, the scenes of ``chip_smoke.py`` and ``apps/profile_gather.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..pwn.projector import PinholeProjector
from . import lie

# The bench pair of bench.py:61-94: three planes, a known small motion.
BENCH_PLANES = [
    (np.array([0.0, 0.0, -1.0]), -2.5),
    (np.array([-1.0, 0.0, 0.0]), -1.2),
    (np.array([0.0, -1.0, 0.0]), -0.9),
]
BENCH_XI = (0.04, -0.02, 0.05, 0.01, 0.03, -0.02)
CANDIDATE_SEED = 7
K_CANDIDATES = 8  # the size of the bench pair's candidate batch

# A closed "room" of 6 axis-aligned planes (normals point inward), with
# asymmetric wall distances so that no 180-degree yaw fits as well.
ROOM_PLANES = [
    (np.array([0.0, 0.0, -1.0]), -2.5),  # back wall z = 2.5
    (np.array([0.0, 0.0, 1.0]), -2.0),  # front wall z = -2.0
    (np.array([-1.0, 0.0, 0.0]), -1.8),  # right wall x = 1.8
    (np.array([1.0, 0.0, 0.0]), -1.3),  # left wall x = -1.3
    (np.array([0.0, -1.0, 0.0]), -1.0),  # floor y = 1.0
    (np.array([0.0, 1.0, 0.0]), -0.8),  # ceiling y = -0.8
]


def render_planes_depth(T_wc, projector: PinholeProjector, planes=None, device="cuda"):
    """Ray-cast planes (n, d) with n.p = d from camera pose T_wc (4x4 numpy)
    -> (H, W) float32 depth tensor on `device`, 0 where no plane is hit."""
    planes = planes if planes is not None else ROOM_PLANES
    H, W = projector.rows, projector.cols
    vs, us = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack(
        [
            (us - projector.cx) / projector.fx,
            (vs - projector.cy) / projector.fy,
            np.ones_like(us, float),
        ],
        -1,
    )
    T_wc = np.asarray(T_wc, np.float64)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    dirs_w = dirs @ R.T
    depth = np.full((H, W), np.inf)
    for n, d in planes:
        denom = dirs_w @ n
        with np.errstate(divide="ignore"):
            z = np.where(np.abs(denom) > 1e-9, (d - t @ n) / denom, np.inf)
        depth = np.minimum(depth, np.where(z > 0.05, z, np.inf))
    depth[~np.isfinite(depth)] = 0.0
    return torch.as_tensor(depth.astype(np.float32), device=device)


def bench_projector(H=480, W=640):
    """The Kinect camera of the bench pair, 640x480 or scaled to H x W
    (``bench.py:72-73``)."""
    f = 525.0 * (W / 640.0)
    return PinholeProjector(rows=H, cols=W, fx=f, fy=f, cx=W / 2 - 0.5, cy=H / 2 - 0.5, min_distance=0.1,
                            max_distance=10.0)


def bench_depth(T_wc, device="cuda", H=480, W=640):
    """The bench pair's three planes seen from camera pose T_wc."""
    return render_planes_depth(T_wc, bench_projector(H, W), BENCH_PLANES, device=device)


def bench_pair(device="cuda", H=480, W=640):
    """The bench pair of ``bench.py:61-94`` (``_make_depth_pair``):
    (reference depth at the identity, current depth at the known motion,
    projector, that motion as a 4x4 numpy pose)."""
    T_gt = lie.se3_exp(torch.tensor(BENCH_XI, dtype=torch.float32)).numpy()
    return bench_depth(np.eye(4), device, H, W), bench_depth(T_gt, device, H, W), bench_projector(H, W), T_gt


def candidate_poses(k, seed=CANDIDATE_SEED):
    """k camera poses (k, 4, 4) float64 numpy, a few cm (sigma 3 cm) and
    degrees (sigma 2 deg) around the identity, drawn from `seed`: the
    reference poses of the bench pair's candidate batch."""
    rng = np.random.default_rng(seed)
    xis = np.concatenate([rng.normal(0.0, 0.03, (k, 3)), rng.normal(0.0, np.deg2rad(2.0), (k, 3))], 1)
    return lie.se3_exp(torch.as_tensor(xis, dtype=torch.float32)).double().numpy()


def default_projector(H=120, W=160):
    return PinholeProjector(
        rows=H,
        cols=W,
        fx=131.25 * W / 160,
        fy=131.25 * W / 160,
        cx=W / 2 - 0.5,
        cy=H / 2 - 0.5,
        min_distance=0.1,
        max_distance=10.0,
    )
