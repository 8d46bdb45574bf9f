"""PyTorch port: solvers/plane_slam.py and solvers/ba.py against the JAX
package, on the CPU.

Problems come from `chip_smoke.plane_world` and `chip_smoke.ba_world`
(numpy, seeded), built as tests/test_planes.py:77-127 and
tests/test_ba.py:15-41 build theirs; JAX's padded graphs cross with
`convert.plane_graph_from_numpy` / `ba_problem_from_numpy`.

- `optimize_plane_graph`: the synthetic room's six planes seen from 5
  poses (tests/test_planes.py:130), and a 40-pose random walk seeing 4 of
  12 random planes each: the chi2 trace within rtol 1e-3, poses and planes
  within atol 1e-3; tests/test_planes.py:130-144's gates on the port alone;
- `optimize_ba`: 8 poses and 60 points seen from every pose
  (tests/test_ba.py:44), and 20 poses with 200 points seen from 5 poses
  each: the trace within rtol 1e-3, poses and points within atol 1e-3;
  tests/test_ba.py:44-63's gates on the port alone; a 30-pose, 1,000-point
  problem (8 views a point) within 1.01x the float64 `control_optimize_ba`;
- `make_plane_graph` / `make_ba_problem` equal to the carried JAX problems,
  padded alike to power-of-two capacities (the solved padded rows are held
  to JAX's too; the gates read the first n rows), and the `*_to_numpy`
  round trips.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from g2o_frontend_tpu.solvers import ba as jba
from g2o_frontend_tpu.solvers import plane_slam as jps
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.solvers import ba as tba
from g2o_frontend_tpu_torch.solvers import plane_slam as tps
from g2o_frontend_tpu_torch.solvers.control import control_optimize_ba

torch.set_num_threads(1)


def _arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


PLANE_CASES = {"room": {}, "walk": dict(n_poses=40, planes=chip_smoke.random_planes(12, 4), per_pose=4, step=0.05,
                                         seed=5)}


@pytest.mark.parametrize("case", list(PLANE_CASES))
def test_optimize_plane_graph_matches_jax(case):
    poses_gt, planes_gt, poses7, planes_init, pp, pl = chip_smoke.plane_world(**PLANE_CASES[case])
    gj = jps.make_plane_graph(poses7, planes_init, pp, pl)
    gt = convert.plane_graph_from_numpy(_arrays(gj), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tps.make_plane_graph(poses7, planes_init, pp, pl, device="cpu"), gt))
    back = convert.plane_graph_to_numpy(gt)
    assert all(np.array_equal(back[k], getattr(gt, k).numpy()) for k in back)
    gjo, trj = jps.optimize_plane_graph(gj, iters=15, cg_iters=60)
    gto, trt = tps.optimize_plane_graph(gt, iters=15, cg_iters=60)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-3)
    np.testing.assert_allclose(gto.poses.numpy(), np.asarray(gjo.poses), atol=1e-3)  # the padded rows too
    np.testing.assert_allclose(gto.planes.numpy(), np.asarray(gjo.planes), atol=1e-3)
    tr = trt.numpy()  # tests/test_planes.py:135-144
    assert tr[-1] < tr[0] * 0.05 and np.isfinite(tr).all()
    np.testing.assert_allclose(gto.planes.numpy()[: len(planes_gt), 3], planes_gt[:, 3], atol=0.03)
    np.testing.assert_allclose(gto.poses.numpy()[0], gt.poses.numpy()[0], atol=1e-6)  # the gauge


BA_CASES = {"all_views": {}, "five_views": dict(n_poses=20, n_points=200, per_point=5, seed=3)}


@pytest.mark.parametrize("case", list(BA_CASES))
def test_optimize_ba_matches_jax(case):
    poses_gt, points_gt, poses7, points_init, (ij, z, w) = chip_smoke.ba_world(**BA_CASES[case])
    obs = [(int(a), int(b), zz, ww) for (a, b), zz, ww in zip(ij, z, w)]
    bj = jba.make_ba_problem(poses7, points_init, obs)
    bt = convert.ba_problem_from_numpy(_arrays(bj), device="cpu")
    for form in (obs, (ij, z, w)):  # JAX's list of tuples, and arrays
        assert all(torch.equal(a, b) for a, b in zip(tba.make_ba_problem(poses7, points_init, form, device="cpu"), bt))
    back = convert.ba_problem_to_numpy(bt)
    assert all(np.array_equal(back[k], getattr(bt, k).numpy()) for k in back)
    bjo, trj = jba.optimize_ba(bj, iters=12, cg_iters=40)
    bto, trt = tba.optimize_ba(bt, iters=12, cg_iters=40)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-3)
    np.testing.assert_allclose(bto.poses.numpy(), np.asarray(bjo.poses), atol=1e-3)  # the padded rows too
    np.testing.assert_allclose(bto.points.numpy(), np.asarray(bjo.points), atol=1e-3)
    tr = trt.numpy()  # tests/test_ba.py:49-56
    assert tr[-1] < tr[0] * 0.01
    err = np.linalg.norm(bto.points.numpy()[: len(points_gt)] - points_gt, axis=1)
    assert np.sqrt((err**2).mean()) < 0.02
    assert np.abs(bto.poses.numpy()[: len(poses_gt), :3] - poses_gt[:, :3, 3]).max() < 0.03


def test_ba_fixed_pose_unmoved():
    """tests/test_ba.py:58 on the port alone."""
    _, _, poses7, points_init, obs = chip_smoke.ba_world(n_poses=4, n_points=20, seed=14)
    ba = tba.make_ba_problem(poses7, points_init, obs, device="cpu")
    ba_opt, _ = tba.optimize_ba(ba, iters=5, cg_iters=20)
    np.testing.assert_allclose(ba_opt.poses.numpy()[0], ba.poses.numpy()[0], atol=1e-6)


def test_ba_reaches_the_float64_control():
    """30 poses, 1,000 points, 8 views a point: within 1.01x the dense
    float64 LM's chi2 (`control_optimize_ba`)."""
    _, _, poses7, points_init, obs = chip_smoke.ba_world(**chip_smoke.BA_CONTROL)
    ba = tba.make_ba_problem(poses7, points_init, obs, device="cpu")
    ctl = control_optimize_ba(ba)
    _, tr = tba.optimize_ba(ba, iters=10, cg_iters=50)
    assert float(tr[-1]) <= 1.01 * ctl["chi2"], (float(tr[-1]), ctl["chi2"])
