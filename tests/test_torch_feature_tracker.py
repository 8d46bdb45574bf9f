"""PyTorch port: slam/feature_tracker.py (FeatureTracker2D) against the JAX
package, on the CPU.

World: tests/test_feature_tracker.py's `simulate_world` (60 frames, 40
landmarks on a circle, range-limited observations without ids), drawn from
a fresh ``default_rng(5)`` as that module's first call draws it.

The JAX tracker draws its RANSAC hypotheses from ``jax.random``; the port
draws every set through `FeatureTracker2D._minimal_sets`, which the
lockstep tests replace with JAX's sequence (``PRNGKey(seed)``, one
``split`` per RANSAC call, then ``engine._sample_minimal_sets``).

Tolerances:
- `_associate_nn` and `_associate_nn_mahal`: indices equal;
- the tracker in lockstep with JAX's draws: the matched landmark of every
  observation and the landmark count equal at every frame, the poses
  within 1e-4 m up to the first window solve (at the end of frame 9;
  float32 LM solves part with their summation order after it; measured
  3.7e-5 m at most), the final trajectories after a global solve by each
  solver ("pcg", "schur", "control") within 1e-2 m RMS and the chi2
  within rtol 1e-3;
- `close_loops_global`, `close_loops_hierarchical` (the coarse float64
  solve and the segment warp) and the per-frame relocalization
  (`frame_closure`) in lockstep: the same merges and associations, poses
  within 1e-5 m;
- the JAX package's own gates (tests/test_feature_tracker.py:51, :82, :94,
  :116, :155, :228, :255) on the port alone, with its own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ransac import engine as jengine
from g2o_frontend_tpu.slam import feature_tracker as jft
from g2o_frontend_tpu_torch.slam import feature_tracker as tft
import chip_smoke
from tests import test_feature_tracker as jtests
from tests.test_validated_slam import _figure_world, _frames

torch.set_num_threads(1)


def _world():
    """The world of tests/test_feature_tracker.py, from a fresh generator
    (that module's own generator is left as it was)."""
    own = jtests.rng
    jtests.rng = np.random.default_rng(5)
    try:
        return jtests.simulate_world()
    finally:
        jtests.rng = own


def jax_draws(seed=0):
    """The JAX tracker's sequence of minimal sets, as `_minimal_sets`."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(n_hyp, m, mask):
        state["key"], sub = jax.random.split(state["key"])
        mask = np.asarray(mask)
        return torch.as_tensor(np.asarray(jengine._sample_minimal_sets(sub, n_hyp, m, len(mask), jnp.asarray(mask))))

    return draw


def _trackers(**cfg):
    jt = jft.FeatureTracker2D(jft.Tracker2DConfig(**cfg))
    tt = tft.FeatureTracker2D(tft.Tracker2DConfig(**cfg), device="cpu")
    tt._minimal_sets = jax_draws(cfg.get("seed", 0))
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_associate_nn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-5, 5, (16, 2)).astype(np.float32)
    lms = np.concatenate([obs[:10] + rng.normal(0, 0.2, (10, 2)), rng.uniform(-5, 5, (22, 2))]).astype(np.float32)
    obs_mask = np.arange(16) < 13
    lm_mask = rng.random(32) < 0.8
    S = rng.normal(0, 0.3, (32, 2, 2))
    S = (S @ S.transpose(0, 2, 1) + 0.05 * np.eye(2)).astype(np.float32)
    Sinv = np.linalg.inv(S).astype(np.float32)
    ref, _ = jft._associate_nn(jnp.asarray(obs), jnp.asarray(obs_mask), jnp.asarray(lms), jnp.asarray(lm_mask), 1.0)
    port, _ = tft._associate_nn(torch.as_tensor(obs), torch.as_tensor(obs_mask), torch.as_tensor(lms),
                                torch.as_tensor(lm_mask), 1.0)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert (port.numpy() >= 0).sum() >= 5
    ref, _ = jft._associate_nn_mahal(jnp.asarray(obs), jnp.asarray(obs_mask), jnp.asarray(lms), jnp.asarray(lm_mask),
                                     jnp.asarray(Sinv), 9.21, 10.0)
    port, _ = tft._associate_nn_mahal(torch.as_tensor(obs), torch.as_tensor(obs_mask), torch.as_tensor(lms),
                                      torch.as_tensor(lm_mask), torch.as_tensor(Sinv), 9.21, 10.0)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_tracker_lockstep_with_jax_draws():
    gt, lms, deltas, obs = _world()
    jt, tt = _trackers(min_landmark_creation_frames=2, optimize_each_n=10)
    for k in range(len(gt)):
        d = np.zeros(3, np.float32) if k == 0 else deltas[k - 1]
        ref = jt.process_frame(d, obs[k])
        port = tt.process_frame(d, obs[k])
        np.testing.assert_array_equal(port, ref, err_msg=f"frame {k}")
        assert len(tt.landmarks) == len(jt.landmarks) and tt.stats() == jt.stats(), k
        if k < 9:  # before the first window solve
            np.testing.assert_allclose(tt.trajectory(), jt.trajectory(), atol=1e-4, rtol=0)
    snaps = jt.snapshot(), tt.snapshot()
    for solver in ("pcg", "schur", "control"):
        for tr, snap in zip((jt, tt), snaps):
            tr.restore(snap)
            tr.cfg.global_solver = solver
        chi2_j, chi2_t = jt.optimize(local=False), tt.optimize(local=False)
        assert abs(chi2_t - chi2_j) <= 1e-3 * chi2_j, solver
        rms = np.sqrt(np.mean(np.sum((tt.trajectory()[:, :2] - jt.trajectory()[:, :2]) ** 2, -1)))
        assert rms < 1e-2, (solver, rms)


def test_close_loops_global_lockstep():
    """tests/test_feature_tracker.py:155's drifted duplicate constellation
    through both packages' sweep, the JAX draws injected."""
    rng_l = np.random.default_rng(3)
    base = rng_l.uniform(-3, 3, (12, 2)).astype(np.float32)
    drift = np.array([1.5, -0.8], np.float32)
    results = []
    for tr in _trackers():
        tr.poses = [np.zeros(3, np.float32) for _ in range(40)]
        tr.landmarks = np.concatenate([base, base + drift]).astype(np.float32)
        tr.lm_alive = np.ones(24, bool)
        tr.lm_seen = np.ones(24, np.int32)
        I = np.eye(2, dtype=np.float32)
        tr.obs_edges = [(p, l, tr.landmarks[l].copy(), I) for p in range(0, 20) for l in range(12)]
        tr.obs_edges += [(p, l, tr.landmarks[l].copy(), I) for p in range(20, 40) for l in range(12, 24)]
        merged = tr.close_loops_global(segment=20, gate=4.0, inlier_threshold=0.3)
        results.append((merged, tr.lm_alive.copy(), [e[1] for e in tr.obs_edges]))
    (mj, aj, ej), (mt, at, et) = results
    assert mt == mj and mt >= 10
    np.testing.assert_array_equal(at, aj)
    assert et == ej


@pytest.mark.parametrize("path", ["hierarchical", "frame_closure"])
def test_closing_paths_lockstep(path):
    """A 15 m drift jump on the second lap, closed by the hierarchical
    sweep; the validated tests' ramped drift, closed frame by frame."""
    if path == "hierarchical":
        cfg = dict(odometry_is_good=True, optimize_each_n=0, incremental_guess_max_feature_distance=1.0)
        lms, circle = np.random.default_rng(3).uniform(-8, 8, (25, 2)), chip_smoke.figure_world(0)[1]
        frames = list(chip_smoke.drifted_frames(lms, circle, drift=(15.0, 9.0, 0.0), ramp=0, blind_ramp=False))
    else:
        cfg = dict(odometry_is_good=True, optimize_each_n=0, frame_closure=True, closure_old_age=25,
                   closure_min_inliers=4, closure_min_obs=4)
        frames = list(_frames(*_figure_world(1)))
    results = []
    for tr in _trackers(**cfg):
        matched = [tr.process_frame(d, o) for d, o in frames]
        merged = tr.close_loops_hierarchical(segment=40, dist_tol=0.3, inlier_threshold=0.8,
                                             min_inliers=6) if path == "hierarchical" else 0
        results.append((matched, merged, tr.n_relocalizations, tr.lm_alive.copy(), tr.trajectory()))
    (mj, nj, rj, aj, tj), (mt, nt, rt, at, tt) = results
    for k, (a, b) in enumerate(zip(mt, mj)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {k}")
    assert (nt, rt) == (nj, rj) and (nt >= 5 if path == "hierarchical" else rt >= 1)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(tt, tj, atol=1e-5, rtol=0)


def test_port_draws_are_seeded_on_the_cpu():
    """Two port trackers of one seed draw the same hypotheses (the card and
    the CPU share the CPU generator's stream)."""
    gt, lms, deltas, obs = _world()
    a = tft.FeatureTracker2D(tft.Tracker2DConfig(seed=3), device="cpu")
    b = tft.FeatureTracker2D(tft.Tracker2DConfig(seed=3), device="cpu")
    mask = np.arange(16) < 11
    assert torch.equal(a._minimal_sets(128, 2, mask), b._minimal_sets(128, 2, mask))
    assert a._minimal_sets(8, 2, mask).device.type == "cpu"
    for k in range(20):
        d = np.zeros(3, np.float32) if k == 0 else deltas[k - 1]
        np.testing.assert_array_equal(a.process_frame(d, obs[k]), b.process_frame(d, obs[k]))
    np.testing.assert_array_equal(a.trajectory(), b.trajectory())


# -- the JAX package's gates, on the port alone ---------------------------------


def test_synthetic_slam_beats_odometry():
    """tests/test_feature_tracker.py:51."""
    gt, lms, deltas, obs = _world()
    tr = tft.FeatureTracker2D(tft.Tracker2DConfig(min_landmark_creation_frames=2, optimize_each_n=10), device="cpu")
    for k in range(len(gt)):
        tr.process_frame(np.zeros(3, np.float32) if k == 0 else deltas[k - 1], obs[k])
    tr.optimize(local=False)
    st = tr.stats()
    assert 0.6 * len(lms) <= st["n_landmarks"] <= 1.8 * len(lms), st
    est = tr.trajectory()[: len(gt)]
    err_slam = np.sqrt(np.mean(np.sum((est[:, :2] - gt[:, :2]) ** 2, -1)))
    x = np.zeros(3, np.float32)
    odo = [x.copy()]
    for dlt in deltas[:-1]:
        c, s = np.cos(x[2]), np.sin(x[2])
        x = np.array([x[0] + c * dlt[0] - s * dlt[1], x[1] + s * dlt[0] + c * dlt[1], x[2] + dlt[2]], np.float32)
        odo.append(x.copy())
    err_odo = np.sqrt(np.mean(np.sum((np.asarray(odo)[:, :2] - gt[:, :2]) ** 2, -1)))
    assert err_slam < 0.7 * err_odo, (err_slam, err_odo)
    assert err_slam < 0.3, err_slam


def test_landmark_merge():
    """tests/test_feature_tracker.py:82."""
    tr = tft.FeatureTracker2D(device="cpu")
    tr.landmarks = np.array([[0, 0], [0.1, 0.0], [5, 5]], np.float32)
    tr.lm_alive = np.array([True, True, True])
    tr.lm_seen = np.array([3, 2, 1], np.int32)
    tr.obs_edges = [(0, 1, np.zeros(2, np.float32), np.eye(2, dtype=np.float32))]
    assert tr.merge_nearby_landmarks(distance=0.5) == 1
    assert tr.lm_alive.sum() == 2
    assert tr.obs_edges[0][1] == 0


def test_reassociate_retargets_and_kills_orphans():
    """tests/test_feature_tracker.py:94."""
    tr = tft.FeatureTracker2D(device="cpu")
    tr.poses = [np.zeros(3, np.float32)]
    tr.landmarks = np.array([[1, 0], [1.3, 0.0], [5, 5]], np.float32)
    tr.lm_alive = np.array([True, True, True])
    tr.lm_seen = np.array([2, 1, 1], np.int32)
    I = np.eye(2, dtype=np.float32)
    tr.obs_edges = [(0, 1, np.array([1.05, 0.0], np.float32), I), (0, 2, np.array([5.0, 5.0], np.float32), I)]
    assert tr.reassociate(gate=1.0) == 1
    assert tr.obs_edges[0][1] == 0 and tr.obs_edges[1][1] == 2
    assert not tr.lm_alive[1] and tr.lm_alive[0] and tr.lm_alive[2]


def _mahal_world(tr):
    n = 21
    tr.poses = [np.array([0.3 * i, 0.0, 0.0], np.float32) for i in range(n)]
    Wo = np.diag([25.0, 25.0, 100.0]).astype(np.float32)
    tr.odom_edges = [(i, i + 1, np.array([0.3, 0.0, 0.0], np.float32), Wo) for i in range(n - 1)]
    tr.landmarks = np.array([[2.0, 1.0], [2.8, 1.0], [4.0, -1.0], [4.8, -1.0]], np.float32)
    tr.lm_alive = np.ones(4, bool)
    tr.lm_seen = np.array([6, 6, 6, 6], np.int32)
    Wm = (np.eye(2) * 100.0).astype(np.float32)

    def local(p, lm):
        return (tr.landmarks[lm] - np.asarray(tr.poses[p][:2])).astype(np.float32)

    tr.obs_edges = ([(p, 0, local(p, 0), Wm) for p in range(0, 6)] + [(p, 1, local(p, 1), Wm) for p in range(15, 21)]
                    + [(p, 2, local(p, 2), Wm) for p in range(0, 6)] + [(p, 3, local(p, 3), Wm) for p in range(0, 6)])


def test_mahalanobis_merge_respects_uncertainty():
    """tests/test_feature_tracker.py:116, and the same merge as JAX's."""
    trs = [jft.FeatureTracker2D(), tft.FeatureTracker2D(device="cpu")]
    for tr in trs:
        _mahal_world(tr)
        assert tr.merge_landmarks_mahalanobis() == 1
    jt, tr = trs
    assert not (tr.lm_alive[0] and tr.lm_alive[1])
    assert tr.lm_alive[2] and tr.lm_alive[3]
    np.testing.assert_array_equal(tr.lm_alive, jt.lm_alive)


def test_close_loops_global_merges_drifted_duplicates():
    """tests/test_feature_tracker.py:155, the port's own draws."""
    rng_l = np.random.default_rng(3)
    base = rng_l.uniform(-3, 3, (12, 2)).astype(np.float32)
    tr = tft.FeatureTracker2D(device="cpu")
    tr.poses = [np.zeros(3, np.float32) for _ in range(40)]
    tr.landmarks = np.concatenate([base, base + np.array([1.5, -0.8], np.float32)]).astype(np.float32)
    tr.lm_alive = np.ones(24, bool)
    tr.lm_seen = np.ones(24, np.int32)
    I = np.eye(2, dtype=np.float32)
    tr.obs_edges = [(p, l, tr.landmarks[l].copy(), I) for p in range(0, 20) for l in range(12)]
    tr.obs_edges += [(p, l, tr.landmarks[l].copy(), I) for p in range(20, 40) for l in range(12, 24)]
    assert tr.close_loops_global(segment=20, gate=4.0, inlier_threshold=0.3) >= 10
    assert tr.lm_alive.sum() <= 14


def test_mahalanobis_association_gate():
    """tests/test_feature_tracker.py:228."""
    obs, obs_mask = torch.tensor([[3.0, 0.0]]), torch.tensor([True])
    lms = torch.tensor([[0.0, 0.0], [3.0, 1.2]])
    Sinv = torch.as_tensor(np.stack([np.linalg.inv(np.diag([4.0, 0.04])),
                                     np.linalg.inv(np.diag([0.04, 0.04]))]).astype(np.float32))
    m, _ = tft._associate_nn_mahal(obs, obs_mask, lms, torch.tensor([True, True]), Sinv, 9.21, 10.0)
    assert int(m[0]) == 0
    m2, _ = tft._associate_nn_mahal(obs, obs_mask, lms, torch.tensor([False, True]), Sinv, 9.21, 10.0)
    assert int(m2[0]) == -1


def test_refresh_landmark_covariances_feeds_association():
    """tests/test_feature_tracker.py:255."""
    rng = np.random.default_rng(0)
    lms_gt = np.array([[2.0, 1.0], [3.0, -1.5], [5.0, 0.5], [1.0, -1.0]])
    tr = tft.FeatureTracker2D(tft.Tracker2DConfig(min_landmark_creation_frames=1, optimize_each_n=0), device="cpu")
    pose = np.zeros(3)
    for k in range(6):
        delta = np.array([0.3, 0.0, 0.02], np.float32) if k else np.zeros(3)
        if k:
            c, s = np.cos(pose[2]), np.sin(pose[2])
            pose = np.array([pose[0] + c * 0.3, pose[1] + s * 0.3, pose[2] + 0.02])
        c, s = np.cos(pose[2]), np.sin(pose[2])
        R = np.array([[c, s], [-s, c]])
        obs = [R @ (l - pose[:2]) + rng.normal(0, 0.01, 2) for l in lms_gt]
        tr.process_frame(delta, np.asarray(obs, np.float32))
        if k == 3:
            tr.optimize(local=False, iters=5)
            tr.refresh_landmark_covariances()
            assert tr.lm_cov is not None and len(tr.lm_cov) >= 4
    assert int(tr.lm_alive.sum()) == len(lms_gt)


# -- reference faults that the port does not carry over ------------------------------


def test_control_optimize_builds_the_graph_once(monkeypatch):
    """The JAX `optimize()` builds `self.graph()` twice on the "control"
    branch (feature_tracker.py:717-727); the port builds one host graph."""
    gt, lms, deltas, obs = _world()
    tr = tft.FeatureTracker2D(tft.Tracker2DConfig(optimize_each_n=0, global_solver="control"), device="cpu")
    for k in range(12):
        tr.process_frame(np.zeros(3, np.float32) if k == 0 else deltas[k - 1], obs[k])
    built = []
    real = tft._pose_graph
    monkeypatch.setattr(tft, "_pose_graph", lambda *a: built.append(a[-1]) or real(*a))
    chi2 = tr.optimize(local=False, iters=5)
    assert built == ["cpu"] and np.isfinite(chi2)


def test_propose_window_closure_returns_none_on_every_failure():
    """With apply=False the JAX method returns 0 from its early exits and
    None from a failed match (feature_tracker.py:490-537); the port returns
    None from each, and 0 with apply=True."""
    tr = tft.FeatureTracker2D(device="cpu")
    assert tr.propose_window_closure(apply=False) is None  # no observations
    assert tr.propose_window_closure(apply=True) == 0
    # a window with landmarks but no old ones
    tr.poses = [np.zeros(3, np.float32) for _ in range(10)]
    tr.landmarks = np.random.default_rng(0).uniform(-5, 5, (8, 2)).astype(np.float32)
    tr.lm_alive = np.ones(8, bool)
    tr.lm_seen = np.ones(8, np.int32)
    tr.lm_last_seen = np.zeros(8, np.int32)
    I = np.eye(2, dtype=np.float32)
    tr.obs_edges = [(p, l, tr.landmarks[l].copy(), I) for p in range(10) for l in range(8)]
    tr.frame = 10
    assert tr.propose_window_closure(min_inliers=4, apply=False) is None
    assert tr.propose_window_closure(min_inliers=4, apply=True) == 0
    jt = jft.FeatureTracker2D()
    assert jt.propose_window_closure(apply=False) == 0  # the reference's early exit
