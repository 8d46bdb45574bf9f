"""PyTorch port: the rest of slice 4 against the JAX package, on the CPU:
slam/constellation.py, slam/graph_merge.py, slam/validated_slam.py (a copy
of the JAX module driving the port's tracker), apps/tracker2d.py and
models/.

Tolerances:
- constellations: `_score_hypotheses` counts equal and errors within rtol
  1e-5; `match_constellations` on tests/test_constellation.py's planted
  constellations (seeds 0, 1, 2) gives the JAX pairs, the transform within
  1e-4 (three host re-fit rounds of float32 Horn fits) and `mean_sq_err`
  within rtol 1e-4 of JAX's `mean_err` (the same value, in m^2);
  `segment_constellations` equal;
- graph merge on tests/test_matchers_merge.py's two overlapping halves of one
  `simulate()` world, JAX's draws fed to the engine: the pairs equal, the
  transform within 1e-5, the merged log's poses and measurements within
  1e-5, `overlap_score` equal; `map_entropy` within rtol 1e-5;
- the JAX package's gates on the port alone: tests/test_constellation.py
  (:48, :62, :71, :77, :100), tests/test_validated_slam.py (:69 seeds 1, 2
  and 7, :94, :117, :134), tests/test_matchers_merge.py's merge and
  tests/test_models.py (:8, :20, :29, :34, :46). The merge test's
  transform gate (within 0.1 m of the truth) holds for JAX's key 0 alone:
  its keys 1-5 land 0.25-0.4 m off on the 0.5 m pose grid with 54 inliers
  against key 0's 53, so the port meets it with JAX's draws, and with its
  own draws reaches at least key 0's inlier count;
- slam/validated_slam.py is the JAX module's code: it calls
  `match_constellations` with no device, so on the default "cuda"; these
  CPU tests bind that function to the CPU;
- `tracker2d --device cpu` on a simulated noassoc log: its JSON line equal
  to a direct `FeatureTracker2D` run's.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from g2o_frontend_tpu import models as jmodels
from g2o_frontend_tpu.ransac import engine as jengine
from g2o_frontend_tpu.slam import constellation as jcon
from g2o_frontend_tpu.slam import graph_merge as jgm
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu_torch import models
from g2o_frontend_tpu_torch.apps import tracker2d
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.io.g2o import G2OLog, read_g2o
from g2o_frontend_tpu_torch.ransac import engine as tengine
from g2o_frontend_tpu_torch.slam import constellation as tcon
from g2o_frontend_tpu_torch.slam import graph_merge as tgm
from g2o_frontend_tpu_torch.slam.feature_tracker import FeatureTracker2D, Tracker2DConfig
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu_torch.slam.validated_slam import (ValidatedSlamConfig, absorb_closure, finish_window_closures,
                                                        run_validated_tracking)
from g2o_frontend_tpu_torch.solvers import pose_graph as pg
from tests.test_constellation import _planted
from tests.test_validated_slam import _figure_world, _frames

torch.set_num_threads(1)

# -- constellations -------------------------------------------------------------------


def test_score_hypotheses_matches_jax():
    rng = np.random.default_rng(0)
    T = np.concatenate([rng.normal(0, 3, (64, 2)), rng.uniform(-3, 3, (64, 1))], 1).astype(np.float32)
    A, B = rng.uniform(-10, 10, (16, 2)).astype(np.float32), rng.uniform(-10, 10, (32, 2)).astype(np.float32)
    am, bm = np.arange(16) < 13, np.arange(32) < 29
    c_ref, e_ref = jcon._score_hypotheses(*(jnp.asarray(x) for x in (T, A, am, B, bm)), np.float32(4.0))
    c, e = tcon._score_hypotheses(*(torch.as_tensor(x) for x in (T, A, am, B, bm)), 4.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5, atol=1e-6)
    assert int(c.max()) >= 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_constellations_matches_jax(seed):
    """tests/test_constellation.py:48 in both packages: the same pairs."""
    A, B, T, truth = _planted(seed)
    kw = dict(dist_tol=0.3, inlier_threshold=0.5, min_inliers=6, seed=seed)
    ref = jcon.match_constellations(A, B, **kw)
    m = tcon.match_constellations(A, B, device="cpu", **kw)
    assert m.ok and ref.ok
    assert m.pairs == ref.pairs and m.n_inliers == ref.n_inliers
    np.testing.assert_allclose(m.transform, ref.transform, atol=1e-4, rtol=0)
    # the reference's `mean_err` is the mean squared residual: the port's
    # field says so by its name and unit (m^2), and keeps the value
    assert abs(m.mean_sq_err - ref.mean_err) <= 1e-4 * ref.mean_err
    WA = tcon._se2_apply_np(m.transform.astype(np.float64), A)
    sq = [float(np.sum((WA[ia] - B[ib]) ** 2)) for ia, ib in m.pairs]
    assert abs(m.mean_sq_err - np.mean(sq)) <= 1e-4 * m.mean_sq_err
    assert not hasattr(m, "mean_err")
    # the JAX package's gates
    assert np.hypot(*(m.transform[:2] - T[:2])) < 0.2
    assert abs((m.transform[2] - T[2] + np.pi) % (2 * np.pi) - np.pi) < 0.02
    found = set(m.pairs)
    assert len(found & truth) >= 10 and not (found - truth)


def test_rejects_unrelated_and_small():
    """tests/test_constellation.py:62 and :71."""
    rng = np.random.default_rng(7)
    A, B = rng.uniform(-20, 20, (15, 2)), rng.uniform(-20, 20, (15, 2))
    assert not tcon.match_constellations(A, B, dist_tol=0.15, inlier_threshold=0.3, min_inliers=7, device="cpu").ok
    assert not tcon.match_constellations(np.zeros((3, 2)), np.zeros((20, 2)), min_inliers=6, device="cpu").ok


def test_segment_constellations_matches_jax():
    """tests/test_constellation.py:77, and equal to JAX's on a tracker's
    edges."""
    poses = np.array([[0, 0, 0], [1, 0, 0], [12, 0, 0], [13, 0, 0]], np.float64)
    obs_edges = [(0, 0, np.array([2.0, 1.0]), None), (2, 0, np.array([0.0, 1.0]), None)]
    segs = tcon.segment_constellations(poses, obs_edges, np.array([True]), segment=2)
    assert [list(s[0]) for s in segs] == [[0], [0]]
    np.testing.assert_allclose(segs[0][1][0], [2.0, 1.0], atol=1e-9)
    np.testing.assert_allclose(segs[1][1][0], [12.0, 1.0], atol=1e-9)
    lms_true, path = _figure_world(3)
    tr = FeatureTracker2D(Tracker2DConfig(optimize_each_n=0), device="cpu")
    for delta, obs in _frames(lms_true, path, loops=1, drift_from=10**9):
        tr.process_frame(delta, obs)
    for a, b in zip(tcon.segment_constellations(tr.poses, tr.obs_edges, tr.lm_alive, 7),
                    jcon.segment_constellations(tr.poses, tr.obs_edges, tr.lm_alive, 7)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_tracker_constellation_closure_merges_drifted_duplicates():
    """tests/test_constellation.py:100: a 15 m drift jump on the second lap;
    the constellation sweep merges the duplicated landmarks."""
    rng = np.random.default_rng(3)
    lms_true = rng.uniform(-8, 8, (25, 2))
    tr = FeatureTracker2D(Tracker2DConfig(odometry_is_good=True, optimize_each_n=0,
                                          incremental_guess_max_feature_distance=1.0), device="cpu")
    path = [np.array([np.cos(t) * 5, np.sin(t) * 5, t + np.pi / 2])
            for t in np.linspace(0, 2 * np.pi, 40, endpoint=False)]
    prev_est = None
    for k, p in enumerate(path * 2):
        est = p + (np.array([15.0, 9.0, 0.0]) if k >= 40 else np.zeros(3))
        rel = lms_true - p[:2]
        c, s = np.cos(p[2]), np.sin(p[2])
        obs = (rel @ np.array([[c, s], [-s, c]]).T)[np.linalg.norm(rel, axis=1) < 6.0]
        if prev_est is None:
            delta = np.zeros(3)
        else:
            c, s = np.cos(prev_est[2]), np.sin(prev_est[2])
            d = est[:2] - prev_est[:2]
            delta = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], est[2] - prev_est[2]])
        prev_est = est
        tr.process_frame(delta, obs)
    n_before = int(tr.lm_alive.sum())
    assert n_before > 30
    merged = tr.close_loops_constellation(segment=40, dist_tol=0.3, inlier_threshold=0.8, min_inliers=6)
    assert merged >= 5 and int(tr.lm_alive.sum()) <= n_before - 5


# -- graph merge ------------------------------------------------------------------------


def _halves():
    """tests/test_matchers_merge.py's two overlapping halves of one world;
    half B in its own frame."""
    world = simulate(SimulatorConfig(n_poses=160, n_landmarks=0, seed=11))
    gt = world.gt_poses
    a_idx, b_idx = np.arange(0, 100), np.arange(60, 160)
    Tb0 = gt[b_idx[0]]
    inv = np.asarray(jlie.se2_inverse(jnp.asarray(Tb0, jnp.float32)))
    poses_b = np.asarray([np.asarray(jlie.se2_compose(jnp.asarray(inv), jnp.asarray(p, jnp.float32)))
                          for p in gt[b_idx]])

    def sub_log(idx, poses):
        pos = {v: k for k, v in enumerate(idx)}
        es = [(pos[i], pos[j], z, w) for (i, j, z, w) in world.odom_edges if i in pos and j in pos]
        return G2OLog(se2_ids=np.arange(len(idx)), se2_poses=np.asarray(poses, float),
                      edge_se2_ij=np.asarray([e[:2] for e in es]), edge_se2_meas=np.asarray([e[2] for e in es]),
                      edge_se2_info=np.asarray([e[3] for e in es]), fixed_ids=np.array([0]))

    return gt[a_idx], poses_b, Tb0, sub_log(a_idx, gt[a_idx]), sub_log(b_idx, poses_b)


def test_graph_merge_matches_jax(monkeypatch):
    poses_a, poses_b, Tb0, log_a, log_b = _halves()
    ref = jgm.match_graphs(poses_a, poses_b, initial_guess=Tb0, gate=1.5)

    def jax_draws(generator, n_hyp, m, mask):  # JAX's PRNGKey(seed=0) draw
        mask = np.asarray(mask.cpu())
        return torch.as_tensor(np.asarray(jengine._sample_minimal_sets(jax.random.PRNGKey(0), n_hyp, m, len(mask),
                                                                       jnp.asarray(mask))))

    monkeypatch.setattr(tengine, "_sample_minimal_sets", jax_draws)
    res = tgm.match_graphs(poses_a, poses_b, initial_guess=Tb0, gate=1.5, device="cpu")
    assert res.ok and ref.ok and res.pairs == ref.pairs
    np.testing.assert_allclose(res.transform, ref.transform, atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.transform[:2], Tb0[:2], atol=0.1)  # tests/test_matchers_merge.py's gate
    score = tgm.overlap_score(poses_a, poses_b, res.transform, radius=0.8, device="cpu")
    assert score == jgm.overlap_score(poses_a, poses_b, ref.transform, radius=0.8)
    merged, merged_ref = tgm.merge_graphs(log_a, log_b, res, device="cpu"), jgm.merge_graphs(log_a, log_b, ref)
    np.testing.assert_array_equal(merged.se2_ids, merged_ref.se2_ids)
    np.testing.assert_array_equal(merged.edge_se2_ij, merged_ref.edge_se2_ij)
    np.testing.assert_allclose(merged.se2_poses, merged_ref.se2_poses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(merged.edge_se2_meas, merged_ref.edge_se2_meas, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(merged.edge_se2_info, merged_ref.edge_se2_info)
    occ = np.random.default_rng(1).uniform(-0.2, 1.0, (40, 50))
    occ[3, 4] = np.nan
    total, h = tgm.map_entropy(occ, device="cpu")
    total_ref, h_ref = jgm.map_entropy(occ)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-6)
    assert abs(float(total) - float(total_ref)) <= 1e-5 * float(total_ref)


def test_match_and_merge_simulated_worlds():
    """tests/test_matchers_merge.py's gates, the port's own draws (the
    transform gate: see the module doc)."""
    poses_a, poses_b, Tb0, log_a, log_b = _halves()
    res = tgm.match_graphs(poses_a, poses_b, initial_guess=Tb0, gate=1.5, device="cpu")
    assert res.ok and len(res.pairs) >= 20
    assert len(res.pairs) >= len(jgm.match_graphs(poses_a, poses_b, initial_guess=Tb0, gate=1.5).pairs)
    assert tgm.overlap_score(poses_a, poses_b, res.transform, radius=0.8, device="cpu") > 0.35
    g, _ = graph2d_from_log(tgm.merge_graphs(log_a, log_b, res, device="cpu"), device="cpu")
    chi2 = pg.optimize_se2(g, iters=8, cg_iters=80)[1].chi2.numpy()
    assert np.isfinite(chi2[-1]) and chi2[-1] <= chi2[0] + 1e-3


# -- validated SLAM (the JAX module's code, on the port's tracker) ---------------------------


@pytest.fixture
def constellations_on_cpu(monkeypatch):
    monkeypatch.setattr(tcon, "match_constellations", functools.partial(tcon.match_constellations, device="cpu"))


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_validated_tracking_closes_drifted_loop(seed, constellations_on_cpu):
    """tests/test_validated_slam.py:69."""
    lms_true, path = _figure_world(seed)
    tr = FeatureTracker2D(Tracker2DConfig(odometry_is_good=True, optimize_each_n=0,
                                          incremental_guess_max_feature_distance=1.0, odom_info=(10.0, 10.0, 100.0)),
                          device="cpu")
    stats = run_validated_tracking(tr, _frames(lms_true, path),
                                   ValidatedSlamConfig(solve_every=20, propose_every=10, window=30, old_age=25,
                                                       drift_base=15.0, min_inliers=4))
    finish_window_closures(tr, window=30, step=15, old_age=25, radius=30.0, min_inliers=4)
    assert int(tr.lm_alive.sum()) <= len(lms_true) + 1
    assert stats["closures"] >= 1
    assert float(np.median(tr.obs_edge_chi2())) < 1.0


def _one_lap(seed, **cfg):
    lms_true, path = _figure_world(seed=seed)
    tr = FeatureTracker2D(Tracker2DConfig(**cfg), device="cpu")
    for delta, obs in _frames(lms_true, path, loops=1, drift_from=10**9):
        tr.process_frame(delta, obs)
    return tr


def _far_pair(tr):
    alive = np.where(tr.lm_alive)[0]
    P = tr.landmarks[alive]
    d2 = np.sum((P[:, None] - P[None, :]) ** 2, -1)
    iu, ju = np.triu_indices(len(alive), 1)
    far = np.argmax(d2[iu, ju] > 64.0)
    return int(alive[iu[far]]), int(alive[ju[far]])


def test_absorb_closure_rejects_poison_batch():
    """tests/test_validated_slam.py:94."""
    tr = _one_lap(5, odometry_is_good=True, optimize_each_n=0, incremental_guess_max_feature_distance=1.0)
    tr.cfg.global_solver = "control"
    chi2 = tr.optimize(local=False, iters=15)
    la, lb = _far_pair(tr)
    before = int(tr.lm_alive.sum())
    n_acc, c2, ns = absorb_closure(tr, [(la, lb)], chi2_gate=chi2 + 50.0)
    assert n_acc == 0 and c2 is None
    assert int(tr.lm_alive.sum()) == before


def test_snapshot_restore_roundtrip():
    """tests/test_validated_slam.py:117."""
    tr = _one_lap(7, optimize_each_n=0)
    snap = tr.snapshot()
    n_lms, n_obs = int(tr.lm_alive.sum()), len(tr.obs_edges)
    alive = np.where(tr.lm_alive)[0]
    tr._merge_landmarks(int(alive[0]), int(alive[1]))
    tr.poses[0] = tr.poses[0] + 5.0
    tr.restore(snap)
    assert int(tr.lm_alive.sum()) == n_lms and len(tr.obs_edges) == n_obs
    np.testing.assert_allclose(tr.trajectory()[0], snap[0][0])


def test_split_inconsistent_landmarks_separates_chimera():
    """tests/test_validated_slam.py:134."""
    tr = _one_lap(11, odometry_is_good=True, optimize_each_n=0, incremental_guess_max_feature_distance=1.0)
    la, lb = _far_pair(tr)
    tr._merge_landmarks(la, lb)
    before = int(tr.lm_alive.sum())
    ns = tr.split_inconsistent_landmarks(spread_gate=3.0, cluster_eps=2.0)
    assert ns >= 1 and int(tr.lm_alive.sum()) == before + ns


# -- the tracker2d command line and the model families ----------------------------------------


def test_tracker2d_app_matches_a_direct_run(tmp_path, capsys):
    world = simulate(SimulatorConfig(n_poses=120, n_landmarks=30, seed=2))
    path = str(tmp_path / "noassoc.g2o")
    chip_smoke.write_noassoc_g2o(path, world)
    log = read_g2o(path)
    assert len(log.se2_ids) == 120 and len(log.features) == len(world.observations) and len(log.xy_ids) == 0
    np.testing.assert_allclose(log.se2_poses, world.noisy_init(), atol=1e-9)
    out = str(tmp_path / "out.g2o")
    assert tracker2d.main([path, "-o", out, "-minLandmarkCreationFrames", "1", "-optimizeEachN", "20",
                           "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tr = FeatureTracker2D(Tracker2DConfig(min_landmark_creation_frames=1, optimize_each_n=20), device="cpu")
    for k, (delta, obs, info) in enumerate(tracker2d.frames_of(log)):
        tr.process_frame(delta, obs, info)
        if (k + 1) % 20 == 0:
            tr.close_loops()
    tr.merge_nearby_landmarks()
    direct = {"chi2": tr.optimize(local=False), "output": out, **tr.stats()}
    assert line == direct
    written = read_g2o(out)
    assert len(written.se2_ids) == 120 and len(written.xy_ids) == direct["n_landmarks"]
    assert len(written.edge_se2xy_ij) == direct["n_obs_edges"]


def test_family_registry():
    """tests/test_models.py:8, and the grid and line SLAM families build on
    the CPU and ingest a scan (tests/test_models.py:34), as JAX's do."""
    assert set(models.FAMILIES) == set(jmodels.FAMILIES)
    with pytest.raises(ValueError, match="unknown family"):
        models.build("nope")
    ranges = np.full(180, 4.0, np.float32)
    angles = np.linspace(-np.pi / 2, np.pi / 2, 180).astype(np.float32)
    for name in ("grid_slam", "line_slam"):
        drv, ref = models.build(name, device="cpu"), jmodels.build(name)
        assert drv.device == torch.device("cpu") and dataclasses.asdict(drv.cfg) == dataclasses.asdict(ref.cfg)
        assert drv.process_scan(ranges, angles, np.zeros(3)) == ref.process_scan(ranges, angles, np.zeros(3))
        assert drv.stats() == ref.stats()
    tuned = models.build("grid_slam", device="cpu", map_half_size=4.0, scans_per_submap=5)
    assert tuned.cfg.map_half_size == 4.0 and tuned._spec().rows == 160


def test_pwn_families_ingest_and_compose():
    """tests/test_models.py:20 and :29 on the CPU."""
    tr = models.build("pwn_rgbd_odometry", rows=48, cols=64, device="cpu")
    depth = torch.full((48, 64), 2.0)
    assert tr.process_frame(depth)["keyframe"]
    assert tr.process_frame(depth * 1.01)["inliers"] >= 0
    tracker, closer, reflector = models.build("pwn_rgbd_slam", rows=48, cols=64, device="cpu")
    assert closer.manager is tracker.manager and reflector.device.type == "cpu"


def test_tracker2d_family_and_recipes():
    """tests/test_models.py:34 (tracker2d) and :46: the recipes are the JAX
    package's, overrides win."""
    assert models.TRACKER2D_RECIPES == jmodels.TRACKER2D_RECIPES
    trk = models.build("tracker2d", device="cpu")
    obs = np.array([[1.0, 0.5], [2.0, -0.5]], np.float32)
    trk.process_frame(np.zeros(3, np.float32), obs)
    trk.process_frame(np.array([0.1, 0.0, 0.0], np.float32), obs)
    for name in ("victoria", "world2000", "world1000-dense-highnoise"):
        tr = models.tracker2d(recipe=name, device="cpu")
        assert tr.cfg == Tracker2DConfig(**models.TRACKER2D_RECIPES[name])
    tr = models.tracker2d(recipe="victoria", cg_iters=99, device="cpu")
    assert tr.cfg.cg_iters == 99 and tr.cfg.odometry_is_good
