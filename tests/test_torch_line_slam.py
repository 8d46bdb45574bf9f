"""PyTorch port: solvers/line_slam.py and slam/line_slam.py against the JAX
package, on the CPU.

- `optimize_line_graph` on tests/test_line_slam.py:20's square-room problem
  (4 wall lines, 6 poses, seed 17's noise; JAX's padded graph carried
  across with `convert.line_graph_from_numpy`): the chi2 trace within rtol
  1e-3, poses and lines within atol 1e-3 (the padded rows too); the JAX
  test's gates on the port alone, on the first n rows; `make_line_graph`
  equal to the carried graph, both padded to power-of-two capacities;
- `line_graph_from_log` on the same problem written as a .g2o file with
  VERTEX_LINE2D / EDGE_SE2_LINE2D records and read back by each package:
  the graphs equal, the solves within the same tolerances;
- `LineSlam2D` on tests/test_line_slam.py:59's 12-frame loop: the line and
  observation counts equal, poses within 1e-3 m and lines within 1e-3
  after `merge_landmarks` and `optimize`, also with a solve every 4 frames;
  the JAX test's gates on the port alone;
- ROADMAP.md section 3's record (not a fault): `LineSlam2D` over 180 scans
  of the 452-scan world with its graph at exact counts against padded as
  the JAX package pads it, in lockstep: equal through the 8th solve, then
  parting;
- `transform_line` / `line_observation` round trip (tests/test_line_slam.py
  :91).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.io import g2o as jg2o
from g2o_frontend_tpu.slam import line_slam as jls
from g2o_frontend_tpu.solvers import line_slam as jsolve
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.io.g2o import G2OLog, read_g2o, write_g2o
from g2o_frontend_tpu_torch.slam import line_slam as tls
from g2o_frontend_tpu_torch.solvers import line_slam as tsolve
from tests.test_laser import square_room_scan

torch.set_num_threads(1)


def _problem():
    """tests/test_line_slam.py:20's world, noise and initial guess."""
    rng = np.random.default_rng(17)
    lines_gt = np.array([[0.0, 4.0], [np.pi / 2, 4.0], [np.pi, 4.0], [-np.pi / 2, 4.0]])
    poses_gt = [np.zeros(3)]
    for _ in range(5):
        poses_gt.append(poses_gt[-1] + np.array([0.4, 0.1, 0.2]))
    pl, pp = [], []
    info2, info3 = np.diag([400.0, 100.0]), np.diag([100.0, 100.0, 400.0])
    for i, x in enumerate(poses_gt):
        for l, ln in enumerate(lines_gt):
            z = tsolve.line_observation(torch.as_tensor(x, dtype=torch.float32),
                                        torch.as_tensor(ln, dtype=torch.float32)).numpy()
            pl.append((i, l, z + rng.normal(0, 0.01, 2), info2))
    for i in range(len(poses_gt) - 1):
        d = poses_gt[i + 1] - poses_gt[i]
        c, s = np.cos(poses_gt[i][2]), np.sin(poses_gt[i][2])
        pp.append((i, i + 1, np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], d[2]]), info3))
    poses_init = np.asarray([poses_gt[0]] + [p + rng.normal(0, 0.08, 3) for p in poses_gt[1:]])
    lines_init = lines_gt + rng.normal(0, 0.05, lines_gt.shape)
    return np.asarray(poses_gt), lines_gt, poses_init, lines_init, pp, pl


def _jax_arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def _solves_agree(gt, gj, iters=15):
    gjo, trj = jsolve.optimize_line_graph(gj, iters=iters, cg_iters=50)
    gto, trt = tsolve.optimize_line_graph(gt, iters=iters, cg_iters=50)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-3)
    np.testing.assert_allclose(gto.poses.numpy(), np.asarray(gjo.poses)[: gto.poses.shape[0]], atol=1e-3)
    np.testing.assert_allclose(gto.lines.numpy(), np.asarray(gjo.lines)[: gto.lines.shape[0]], atol=1e-3)
    return gto, trt


def test_optimize_line_graph_matches_jax():
    poses_gt, lines_gt, poses_init, lines_init, pp, pl = _problem()
    gj = jsolve.make_line_graph(poses_init, lines_init, pp, pl)
    gt = convert.line_graph_from_numpy(_jax_arrays(gj), device="cpu")
    made = tsolve.make_line_graph(poses_init, lines_init, pp, pl, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(made, gt))
    gto, trt = _solves_agree(gt, gj)
    tr = trt.numpy()  # tests/test_line_slam.py:51-55
    assert tr[-1] < tr[0] * 0.05
    np.testing.assert_allclose(gto.lines.numpy()[: len(lines_gt), 1], lines_gt[:, 1], atol=0.03)
    np.testing.assert_allclose(gto.poses.numpy()[: len(poses_gt)], poses_gt, atol=0.05)
    back = convert.line_graph_to_numpy(gt)
    assert all(np.array_equal(back[k], getattr(gt, k).numpy()) for k in back)


def test_line_graph_from_log_matches_jax(tmp_path):
    _, _, poses_init, lines_init, pp, pl = _problem()
    pose_ids, line_ids = np.arange(100, 106), np.arange(500, 504)
    log = G2OLog(se2_ids=pose_ids, se2_poses=poses_init, edge_se2_ij=pose_ids[np.array([e[:2] for e in pp])],
                 edge_se2_meas=np.asarray([e[2] for e in pp]), edge_se2_info=np.asarray([e[3] for e in pp]),
                 line2d_ids=line_ids, line2d_params=lines_init, line2d_endpoints=np.full((4, 2), -1),
                 edge_se2line_ij=np.stack([pose_ids[[e[0] for e in pl]], line_ids[[e[1] for e in pl]]], 1),
                 edge_se2line_meas=np.asarray([e[2] for e in pl]), edge_se2line_info=np.asarray([e[3] for e in pl]),
                 fixed_ids=np.array([100]))
    path = str(tmp_path / "lines.g2o")
    write_g2o(path, log)
    gt, pids, lids = tsolve.line_graph_from_log(read_g2o(path), device="cpu")
    gj, jpids, jlids = jsolve.line_graph_from_log(jg2o.read_g2o(path))
    assert np.array_equal(pids, jpids) and np.array_equal(lids, jlids) and np.array_equal(pids, pose_ids)
    for name in gt._fields:
        np.testing.assert_allclose(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)), rtol=1e-6, err_msg=name)
    _solves_agree(gt, gj, iters=8)


def _loop_frames():
    """tests/test_line_slam.py:59's 12 frames around the square room."""
    rng = np.random.default_rng(17)
    x, frames = np.zeros(3), []
    for _ in range(12):
        ranges, angles = square_room_scan(pose=tuple(x))
        delta_true = np.array([0.25, 0.0, 2 * np.pi / 12])
        frames.append((np.asarray(ranges), np.asarray(angles), delta_true + rng.normal(0, 0.01, 3), x.copy()))
        c, s = np.cos(x[2]), np.sin(x[2])
        x = np.array([x[0] + c * delta_true[0] - s * delta_true[1], x[1] + s * delta_true[0] + c * delta_true[1],
                      x[2] + delta_true[2]])
    return frames


@pytest.mark.parametrize("optimize_each_n", [0, 4])
def test_line_slam_matches_jax(optimize_each_n):
    js = jls.LineSlam2D(jls.LineSlam2DConfig(optimize_each_n=optimize_each_n))
    ts = tls.LineSlam2D(tls.LineSlam2DConfig(optimize_each_n=optimize_each_n), device="cpu")
    frames = _loop_frames()
    for ranges, angles, delta, _ in frames:
        assert ts.process_scan(ranges, angles, delta) == js.process_scan(ranges, angles, delta)
        np.testing.assert_allclose(np.asarray(ts.poses), np.asarray(js.poses), atol=1e-3)
    assert ts.stats() == js.stats()
    assert [e[:2] for e in ts.pl_edges] == [e[:2] for e in js.pl_edges]
    assert ts.merge_landmarks() == js.merge_landmarks()
    assert [e[:2] for e in ts.pl_edges] == [e[:2] for e in js.pl_edges]
    chi2_t, chi2_j = ts.optimize(), js.optimize()
    np.testing.assert_allclose(chi2_t, chi2_j, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(ts.poses), np.asarray(js.poses), atol=1e-3)
    np.testing.assert_allclose(ts.lines, js.lines, atol=1e-3)
    st = ts.stats()  # tests/test_line_slam.py:84-89
    assert 4 <= st["n_lines"] <= 8 and np.isfinite(chi2_t)
    gt = np.asarray([f[3] for f in frames])
    assert np.linalg.norm(np.asarray(ts.poses)[:, :2] - gt[:, :2], axis=1).mean() < 0.2


def test_transform_line_roundtrip():
    """tests/test_line_slam.py:91 with the port's functions."""
    pose, local = np.array([1.0, -0.5, 0.7]), np.array([0.3, 2.0])
    world = tls.transform_line(pose, local)
    np.testing.assert_allclose(world, jls.transform_line(pose, local), atol=1e-12)
    back = tsolve.line_observation(torch.as_tensor(pose, dtype=torch.float32),
                                   torch.as_tensor(world, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(back, np.asarray(jsolve.line_observation(jnp.asarray(pose, jnp.float32),
                                                                        jnp.asarray(world, jnp.float32))), atol=1e-6)
    da = abs((back[0] - local[0] + np.pi) % (2 * np.pi) - np.pi)
    if da > np.pi / 2:
        back = np.array([back[0] + np.pi, -back[1]])
        da = abs((back[0] - local[0] + np.pi) % (2 * np.pi) - np.pi)
    assert da < 1e-5
    np.testing.assert_allclose(back[1], local[1], atol=1e-5)


def test_line_slam_config_carries_extractor():
    cfg = tls.LineSlam2DConfig()
    assert dataclasses.asdict(cfg.extractor) == dataclasses.asdict(jls.LineSlam2DConfig().extractor)


def test_line_slam_padded_graph_parts_from_exact_counts(monkeypatch):
    """Not a fault, on record (ROADMAP.md section 3, and
    tests/test_torch_line_slam_lockstep.py against the JAX package):
    `LineSlam2D.optimize` solves its graph at exact counts because, padded
    to the JAX package's capacities (`make_line_graph`), the float32 sums
    round otherwise and the run ends elsewhere. Over the first 180 scans of the 452-scan laser world
    the two runs, in lockstep, agree through the 8th solve (scan 119: the
    same lines, poses within 3e-3 m); the 9th (scans 120-134) moves them
    apart by centimetres, and after `merge_landmarks` and the last solve the
    line counts part by more than 5% (157 at exact counts, 141 padded, on
    one thread) with the same observations: amplified rounding, which keeps
    the card's padded run outside `chip_smoke.LINE_BAND`."""
    from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world

    world = simulate_laser_world(LaserWorldConfig(n_poses=180, n_beams=360, room=12.0, max_range=16.0,
                                                  odom_noise=(0.08, 0.05, 0.02), seed=0))
    exact_graph, shapes = tls._line_graph, {"exact": set(), "padded": set()}
    padded_graph = lambda p, l, pp, pl, f, caps, dtype, device: tsolve.make_line_graph(p, l, pp, pl, f, dtype, device)
    runs = {"exact": tls.LineSlam2D(device="cpu"), "padded": tls.LineSlam2D(device="cpu")}
    graphs = {"exact": exact_graph, "padded": padded_graph}
    optimize = tls.optimize_line_graph

    def recording(name):
        def solve(g, **kw):
            shapes[name].add((g.poses.shape[0], g.lines.shape[0], g.pp_mask.shape[0], g.pl_mask.shape[0],
                              int(g.pose_mask.sum()), int(g.line_mask.sum()), int(g.pp_mask.sum()),
                              int(g.pl_mask.sum())))
            return optimize(g, **kw)
        return solve

    def step(name, *args):
        monkeypatch.setattr(tls, "_line_graph", graphs[name])
        monkeypatch.setattr(tls, "optimize_line_graph", recording(name))
        return runs[name].process_scan(*args)

    apart = []
    for k in range(180):
        args = (*world["scans"][k], world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32))
        step("exact", *args), step("padded", *args)
        a, b = runs["exact"], runs["padded"]
        apart.append((len(a.lines), len(b.lines), float(np.abs(np.asarray(a.poses) - np.asarray(b.poses)).max())))
    for name in runs:
        monkeypatch.setattr(tls, "_line_graph", graphs[name])
        monkeypatch.setattr(tls, "optimize_line_graph", recording(name))
        runs[name].merge_landmarks()
        runs[name].optimize()
    assert shapes["exact"] and all(s[:4] == s[4:] for s in shapes["exact"])  # `LineSlam2D` as it ships: exact counts
    assert shapes["padded"] and all(s[:4] == tuple(tsolve._cap(max(c, 1)) for c in s[4:]) for s in shapes["padded"])
    assert all(la == lb and d < 3e-3 for la, lb, d in apart[:120]), apart[:120]
    assert max(d for _, _, d in apart[135:]) > 0.05
    exact, padded = runs["exact"].stats(), runs["padded"].stats()
    assert exact["n_poses"] == padded["n_poses"] and exact["n_obs"] == padded["n_obs"]
    assert abs(exact["n_lines"] - padded["n_lines"]) > 0.05 * exact["n_lines"], (exact, padded)
