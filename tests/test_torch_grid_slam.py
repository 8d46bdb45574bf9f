"""PyTorch port: slam/grid_slam.py (`GridSlam2D`) against the JAX package,
on the CPU.

- tests/test_grid_slam.py's 20-scan square room (seed 41's odometry noise,
  the range noise seeded per scan):
  the match flags of every scan, the submap and edge counts and every
  edge's ends equal, the poses within 1e-3 m (observed ~5e-7) before and
  after `optimize(iters=8, cg_iters=80)`, the chi2 within rtol 1e-3; the
  same for the first 2 scans with the gradient polish on (3 steps), one
  polished match. The polish normalizes each step by the gradient's
  length, and at a matched pose the gradient is near zero, so its
  direction follows the rounding: on this sequence the two packages' poses
  part by 2.1e-7 m after scan 2, then 1.0e-2 and 2.4e-2 m after scans 3
  and 4 (`gradient_refine` itself is held from a pose off the optimum in
  tests/test_torch_laser.py);
- the JAX package's ground-truth gate (tests/test_grid_slam.py:89) on the
  port alone: the 120-scan laser world, ATE below 0.75x the odometry's and
  below 0.35 m.
"""
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.slam import grid_slam as jgs
from g2o_frontend_tpu_torch.slam import grid_slam as tgs
from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world
from g2o_frontend_tpu_torch.utils.evaluation import ate_xy
from tests.test_torch_laser import room_scan

torch.set_num_threads(1)


def _room_sequence(n=20):
    rng = np.random.default_rng(41)
    x, scans = np.zeros(3), []
    for _ in range(n):
        ranges, angles = room_scan(tuple(x), 0.005, seed=len(scans))
        delta_true = np.array([0.2, 0.0, 0.15])
        scans.append((np.asarray(ranges), np.asarray(angles), delta_true + rng.normal(0, 0.02, 3)))
        c, s = np.cos(x[2]), np.sin(x[2])
        x = np.array([x[0] + c * delta_true[0] - s * delta_true[1], x[1] + s * delta_true[0] + c * delta_true[1],
                      x[2] + delta_true[2]])
    return scans


@pytest.mark.parametrize("n_scans, polish", [(20, 0), (2, 3)])
def test_grid_slam_matches_jax(n_scans, polish):
    cfg = dict(map_half_size=8.0, scans_per_submap=8, min_match_score=5.0, gradient_polish_steps=polish)
    js, ts = jgs.GridSlam2D(jgs.GridSlamConfig(**cfg)), tgs.GridSlam2D(tgs.GridSlamConfig(**cfg), device="cpu")
    for scan in _room_sequence(n_scans):
        assert ts.process_scan(*scan) == js.process_scan(*scan)
    assert ts.stats() == js.stats()
    assert [e[:2] for e in ts.edges] == [e[:2] for e in js.edges]
    np.testing.assert_allclose(np.asarray(ts.poses), np.asarray(js.poses), atol=1e-3)
    np.testing.assert_allclose(ts.optimize(iters=8, cg_iters=80), js.optimize(iters=8, cg_iters=80), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(ts.poses), np.asarray(js.poses), atol=1e-3)
    assert ts.stats()["n_submaps"] == 1 + n_scans // 8 and all(e[2].shape == (3,) for e in ts.edges)


def test_grid_slam_beats_odometry_on_ground_truth():
    """tests/test_grid_slam.py:89 on the port alone."""
    w = simulate_laser_world(LaserWorldConfig(n_poses=120, n_beams=360, room=6.0, max_range=16.0,
                                              odom_noise=(0.08, 0.05, 0.02)))
    slam = tgs.GridSlam2D(tgs.GridSlamConfig(map_half_size=8.4, scans_per_submap=12, min_match_score=30.0),
                          device="cpu")
    slam.process_scan(*w["scans"][0], np.zeros(3, np.float32))
    for k in range(1, len(w["scans"])):
        slam.process_scan(*w["scans"][k], w["odom_deltas"][k - 1])
    slam.optimize(iters=10, cg_iters=100)
    est = np.asarray(slam.poses)
    gt = w["gt_poses"][: len(est)]
    odo = [gt[0]]
    for d in w["odom_deltas"]:
        a = odo[-1]
        c, s = np.cos(a[2]), np.sin(a[2])
        odo.append(np.array([a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], a[2] + d[2]]))
    ate_slam = ate_xy(est[:, :2], gt[:, :2])["rmse"]
    ate_odo = ate_xy(np.asarray(odo)[: len(est), :2], gt[:, :2])["rmse"]
    assert ate_slam < ate_odo * 0.75, (ate_slam, ate_odo)
    assert ate_slam < 0.35, ate_slam
