"""PyTorch port: `slam.pwn_slam.PwnSlam`, the SLAM step as a library entry
point, and the closer's K buckets, on the CPU at the synthetic orbit's
96x128, two laps of a noisy room (the noise seeded), against:

- the loop `apps/pwn_slam.run` ran before `PwnSlam` existed (a verbatim
  copy below): every frame's metrics, every pose, relation and consensus
  counter, the closures and the final chi2 equal, bit for bit (the same
  code in the same order);
- the closer at exact K (`map_closer.padded_k` the identity): every batch's
  results on the real candidates bit for bit, and the same map; no padded
  slot becomes a relation;
- the plain reference of the benchmark (`perfbench/reference/pwn_slam.py`):
  each candidate that passed the gates matched again from its recorded
  guess on the program's own clouds (so that the converters' float32
  normals, which part by ~1e-5, stay out): transform within 1e-4 m and
  rad, aligner and image inliers within 1% (each is an alignment of
  float32 sums in another order, and a pixel on the 50 mm rule or a
  projection's rounding edge flips with the last bits); every gate
  decision equal; every consensus decision equal (both float64); the final
  map solve's chi2 within 1e-3 of the float64 optimum's and its positions
  within 1 mm (10 float32 LM iterations over a graph whose weakest
  direction moves by less); every recorded map solve within 1e-4 m and a
  relative 1e-6 in chi2 of the reference's solve at the same budget
  (`lm_se3`: the same LM iterations and CG steps in float64; the port's
  float32 CG over graphs of at most ~20 nodes reads ~1e-5 m);
- its spans nest as named and its counters add up; nothing is recorded
  until a `SlamRecord` is attached.
"""
import copy

import numpy as np
import pytest
import torch

from g2o_frontend_tpu_torch.apps.pwn_slam import synthetic_configs, synthetic_orbit
from g2o_frontend_tpu_torch.graph import reflector as reflector_mod
from g2o_frontend_tpu_torch.graph.reflector import MapReflector
from g2o_frontend_tpu_torch.slam import map_closer
from g2o_frontend_tpu_torch.slam.map_closer import MapCloser
from g2o_frontend_tpu_torch.slam.map_merger import MapMerger
from g2o_frontend_tpu_torch.slam.pwn_slam import PwnSlam, SlamRecord
from g2o_frontend_tpu_torch.slam.pwn_tracker import PwnTracker, PwnTrackerConfig
from g2o_frontend_tpu_torch.utils import profiling
from g2o_frontend_tpu_torch.utils.synth import render_planes_depth
from perfbench.reference import pwn as ref
from perfbench.reference import pwn_slam as ref_slam

torch.set_num_threads(2)

LAP = 24
SEEDS = [3, 11]


def _frames(seed):
    """Two laps of the synthetic orbit, each depth with seeded noise of
    sigma 2 mm."""
    proj = synthetic_configs()[0]
    rng = np.random.default_rng(seed)
    clean = [render_planes_depth(T, proj, device="cpu").numpy() for T in synthetic_orbit(LAP)]
    return [(d + np.where(d > 0, rng.normal(0.0, 2e-3, d.shape), 0.0)).astype(np.float32) for d in clean * 2]


def _configs():
    proj, ccfg, acfg, closer = synthetic_configs()
    return proj, ccfg, acfg, PwnTrackerConfig(new_frame_inliers_fraction=0.7, min_cloud_inliers=50), closer


def _old_loop(frames, optimize_each_n_keyframes=5):
    """`apps/pwn_slam.run`'s loop as it was written before `PwnSlam`,
    verbatim but for its configs' source: (tracker, closer, per-frame
    metrics, final chi2)."""
    proj, ccfg, acfg, tcfg, closer_cfg = _configs()
    device = torch.device("cpu")
    tracker = PwnTracker(proj, ccfg, acfg, tcfg, device=device)
    closer = MapCloser(tracker.manager, tracker.cache, proj, acfg, closer_cfg)
    reflector = MapReflector(tracker.manager, device=device)
    merger = MapMerger(tracker.manager, list_size=5)
    n_closures = 0
    kf_at_last_opt = 0
    metrics = []
    for depth in frames:
        m = tracker.process_frame(depth)
        metrics.append(dict(m))
        if m["keyframe"] and tracker.n_keyframes > 2:
            key_node = tracker.manager.nodes[-1]
            rels = closer.process_key_node(key_node)
            merger.process_key_node(key_node)
            n_closures += len(rels)
            if rels or tracker.n_keyframes - kf_at_last_opt >= optimize_each_n_keyframes:
                reflector.optimize_hierarchical(iters=5, cg_iters=40)
                kf_at_last_opt = tracker.n_keyframes
                tracker.global_T = tracker.prev_kf_node.transform.copy()
                tracker.prev_kf_T = tracker.global_T.copy()
    chi2, _ = reflector.optimize_hierarchical(iters=10, cg_iters=60)
    return tracker, closer, metrics, n_closures, chi2


def _new_slam():
    """A `PwnSlam` on the CPU with a `SlamRecord` attached."""
    proj, ccfg, acfg, tcfg, closer_cfg = _configs()
    slam = PwnSlam(proj, ccfg, acfg, tcfg, closer_cfg, device="cpu")
    slam.record = SlamRecord()
    return slam


def _slam(frames):
    slam = _new_slam()
    out = [slam.process_frame(d) for d in frames]
    return slam, out, slam.finish()


@pytest.fixture(scope="module", params=SEEDS)
def runs(request):
    frames = _frames(request.param)
    slam, out, chi2 = _slam(frames)
    return dict(frames=frames, slam=slam, out=out, chi2=chi2)


def _relations(manager):
    return [(r.node_from.seq, r.node_to.seq, r.is_closure, r.accepted, r.consensus_times_checked,
             r.consensus_cum_inlier, r.consensus_cum_outlier_times, r.transform, r.information)
            for r in manager.relations]


def _same_relations(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:7] == y[:7]
        np.testing.assert_array_equal(x[7], y[7])
        np.testing.assert_array_equal(x[8], y[8])


def test_pwn_slam_equals_the_apps_loop_frame_by_frame(runs):
    tracker, closer, metrics, n_closures, chi2 = _old_loop(runs["frames"])
    slam = runs["slam"]
    assert [{k: m[k] for k in want} for m, want in zip(runs["out"], metrics)] == metrics
    np.testing.assert_array_equal(np.stack(slam.tracker.trajectory), np.stack(tracker.trajectory))
    assert [n.seq for n in slam.manager.nodes] == [n.seq for n in tracker.manager.nodes]
    for a, b in zip(slam.manager.nodes, tracker.manager.nodes):
        np.testing.assert_array_equal(a.transform, b.transform)
    _same_relations(_relations(slam.manager), _relations(tracker.manager))
    assert slam.n_closures == n_closures == sum(m["closures"] for m in runs["out"]) >= 1
    assert slam.closer.batch_sizes == closer.batch_sizes
    assert runs["chi2"] == chi2
    assert sum(m["map_solved"] for m in runs["out"]) + 1 == len(slam.record.solves)


def test_bucketed_closer_equals_the_exact_k_closer(runs, monkeypatch):
    monkeypatch.setattr(map_closer, "padded_k", lambda k: k)
    exact, _, chi2 = _slam(runs["frames"])
    slam = runs["slam"]
    padded = [b for b in slam.record.closer if hasattr(b, "key_frame")]
    plain = [b for b in exact.record.closer if hasattr(b, "key_frame")]
    assert len(padded) == len(plain) >= 3
    assert any(b.padded_k > len(b.frames) for b in padded)
    for a, b in zip(padded, plain):
        assert b.padded_k == len(b.frames) and a.frames == b.frames and a.key_frame == b.key_frame
        for field in ("guesses", "transform", "information", "cloud_inliers", "image_nonzeros", "image_inliers",
                      "image_outliers", "passed"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    _same_relations(_relations(slam.manager), _relations(exact.manager))
    assert runs["chi2"] == chi2


def test_no_padded_slot_becomes_a_relation(runs):
    slam = runs["slam"]
    batches = [b for b in slam.record.closer if hasattr(b, "key_frame")]
    assert all(b.padded_k == map_closer.padded_k(len(b.frames)) for b in batches)
    frame_of = {n.seq: n.payload.get("frame") for n in slam.manager.nodes}
    made = {}
    for b in batches:
        made.setdefault(b.key_frame, set()).update(f for f, p in zip(b.frames, b.passed) if p)
    # every closure (kept, accepted or still pending) joins a key frame to a
    # candidate that passed the gates in one of the key frame's batches
    closures = [r for r in slam.manager.relations if r.is_closure]
    assert closures
    for r in closures:
        assert frame_of[r.node_from.seq] in made[frame_of[r.node_to.seq]]


def test_padded_k_is_the_jax_closers_bucket():
    assert [map_closer.padded_k(k) for k in (1, 7, 8, 9, 16, 17, 64, 65, 128, 129)] == [
        8, 8, 8, 16, 16, 32, 64, 128, 128, 256]


def _cam(proj):
    return {"rows": proj.rows, "cols": proj.cols, "fx": proj.fx, "fy": proj.fy, "cx": proj.cx, "cy": proj.cy,
            "min_distance": proj.min_distance, "max_distance": proj.max_distance}


def _ref_cloud(c):
    return ref.RefCloud(c.p, c.n, c.curv, c.op, c.on, c.valid)


def test_closer_matches_the_reference(runs):
    slam = runs["slam"]
    proj, _, acfg, _, ccfg = _configs()
    cam = _cam(proj)
    a = {k: getattr(acfg, k) for k in ("outer_iterations", "inner_iterations", "inlier_distance_threshold",
                                       "inlier_normal_angular_threshold", "flat_curvature_threshold",
                                       "inlier_curvature_ratio_threshold", "inlier_max_chi2", "damping")}
    gates = {k: getattr(ccfg, k) for k in ("frame_min_nonzero_threshold", "frame_max_outliers_threshold",
                                           "frame_min_inliers_threshold")}
    cache = slam.tracker.cache
    compared = 0
    for b in (b for b in slam.record.closer if hasattr(b, "key_frame")):
        cur = _ref_cloud(cache.get(b.key_frame))
        for c, frame in enumerate(b.frames):
            m = ref_slam.match(_ref_cloud(cache.get(frame)), cur, cam, b.guesses[c], a)
            T = m.transform.double().numpy()
            nz, inl, outl = int(m.image_nonzeros), int(m.image_inliers), int(m.image_outliers)
            assert ref_slam.gates(nz, inl, outl, T, m.information.numpy(), gates) == bool(b.passed[c])
            if not b.passed[c]:
                continue  # a rejected candidate's alignment may wander: only its gate counts
            compared += 1
            np.testing.assert_allclose(b.transform[c], T, atol=1e-4)
            assert abs(int(b.cloud_inliers[c]) - int(m.cloud_inliers)) <= 0.01 * int(m.cloud_inliers)
            assert abs(int(b.image_inliers[c]) - inl) <= 0.01 * inl
            np.testing.assert_array_equal(b.information[c], m.information.double().numpy())
    assert compared >= 3


def test_consensus_matches_the_reference(runs):
    ccfg = _configs()[4]
    cfg = {k: getattr(ccfg, k) for k in ("consensus_inlier_translational_threshold",
                                         "consensus_inlier_rotational_threshold", "consensus_min_times_checked")}
    votes = [v for v in runs["slam"].record.closer if hasattr(v, "decisions")]
    assert votes and any(d == "accepted" for v in votes for d in v.decisions)
    for v in votes:
        assert ref_slam.consensus(v.pose_from, v.pose_to, v.transform, v.from_in_current, v.counters_before,
                                  cfg) == v.decisions


def test_map_solve_matches_the_float64_optimum(runs):
    s = runs["slam"].record.solves[-1]  # the final solve, 10 x 60
    assert (s.edges[:, 0] != s.edges[:, 1]).all() and len(s.frames) == len(s.poses_in)
    X, chi2_opt, iters = ref_slam.optimize_se3(s.poses_in, s.edges, s.transforms, s.information, s.gauge)
    chi2_prog = ref_slam.chi2_se3(torch.as_tensor(s.poses_out), s.edges, s.transforms, s.information)
    assert chi2_prog >= chi2_opt * (1 - 1e-9)
    assert chi2_prog - chi2_opt <= 1e-3 * max(chi2_opt, len(s.edges))
    np.testing.assert_allclose(s.poses_out[:, :3, 3], X[:, :3, 3].numpy(), atol=1e-3)
    np.testing.assert_array_equal(s.poses_out[s.gauge], s.poses_in[s.gauge])


def test_map_solves_match_the_reference_at_their_budget(runs):
    solves = runs["slam"].record.solves
    assert len(solves) >= 3 and {(s.iters, s.cg_iters) for s in solves} == {(5, 40), (10, 60)}
    for s in solves:
        X, trace = ref_slam.lm_se3(s.poses_in, s.edges, s.transforms, s.information, s.gauge, s.iters, s.cg_iters)
        chi2_prog = ref_slam.chi2_se3(torch.as_tensor(s.poses_out), s.edges, s.transforms, s.information)
        assert abs(chi2_prog - trace[-1]) <= 1e-6 * max(trace[-1], len(s.edges))
        np.testing.assert_allclose(s.poses_out[:, :3, 3], X[:, :3, 3].numpy(), atol=1e-4)


def test_record_is_off_until_attached():
    proj, ccfg, acfg, tcfg, closer_cfg = _configs()
    slam = PwnSlam(proj, ccfg, acfg, tcfg, closer_cfg, device="cpu")
    frames = _frames(SEEDS[0])[:LAP]
    for d in frames[:LAP // 2]:
        slam.process_frame(d)
    assert slam.record is None and slam.closer.record is None and slam.reflector.record is None
    slam.record = rec = SlamRecord()
    assert slam.closer.record is rec.closer and slam.reflector.record is rec.solves
    out = [slam.process_frame(d) for d in frames[LAP // 2:]]
    assert [f.frame for f in rec.frames] == list(range(LAP // 2, LAP))
    assert len(rec.solves) == sum(m["map_solved"] for m in out)
    slam.record = None
    assert slam.closer.record is None and slam.reflector.record is None


def test_spans_nest_and_counters_add_up():
    frames = _frames(SEEDS[0])
    slam = _new_slam()
    for d in frames[:LAP]:
        slam.process_frame(d)
    names = ("batches", "candidates", "padded", "committed", "rejected")
    before = {k: getattr(map_closer, k) for k in names}
    solves, recomputes = reflector_mod.solves, slam.tracker.cache.recomputes
    n_rec = {k: len(getattr(slam.record, k)) for k in ("closer", "solves")}
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = [slam.process_frame(d) for d in frames[LAP:]]
    rec = profiling.spans()
    by_id = {s.id: s for s in rec}

    def parent(s):
        return by_id.get(s.parent)

    frames_ = [s for s in rec if s.name == "pwn_slam.frame"]
    assert [s.request for s in frames_] == list(range(LAP, 2 * LAP)) and all(s.parent == -1 for s in frames_)
    closer = [s for s in rec if s.name == "closer"]
    assert closer and all(parent(s).name == "pwn_slam.frame" for s in closer)
    for name in ("closer:clouds", "closer:match", "closer:consensus"):
        assert all(parent(s).name == "closer" for s in rec if s.name == name)
    solve = [s for s in rec if s.name == "map_solve"]
    assert solve and all(parent(s).name == "pwn_slam.frame" for s in solve)
    assert all(parent(s).name == "pwn_slam.frame" for s in rec if s.name == "pwn_tracker.frame")

    batches = [b for b in slam.record.closer[n_rec["closer"]:] if hasattr(b, "key_frame")]
    votes = [v for v in slam.record.closer[n_rec["closer"]:] if hasattr(v, "decisions")]
    assert [s.request for s in rec if s.name == "closer:match"] == [b.padded_k for b in batches]
    grew = {k: getattr(map_closer, k) - before[k] for k in names}
    assert grew["batches"] == len(batches) == sum(m["batches"] for m in out) >= 1
    assert grew["candidates"] == sum(len(b.frames) for b in batches)
    assert grew["padded"] == sum(b.padded_k - len(b.frames) for b in batches)
    assert grew["committed"] == sum(m["closures"] for m in out) == sum(
        d == "accepted" for v in votes for d in v.decisions)
    assert grew["rejected"] == sum(d == "removed" for v in votes for d in v.decisions)
    n_solves = len(slam.record.solves) - n_rec["solves"]
    assert reflector_mod.solves - solves == sum(m["map_solved"] for m in out) == n_solves
    assert 0 <= slam.closer_recomputes <= slam.tracker.cache.recomputes
    assert slam.tracker.cache.recomputes - recomputes >= 0


def test_warm_up_leaves_the_map_as_it_was():
    frames = _frames(SEEDS[1])[:LAP]
    slam = _new_slam()
    for d in frames:
        slam.process_frame(d)
    poses = [n.transform.copy() for n in slam.manager.nodes]
    rels = copy.copy(_relations(slam.manager))
    counts = [getattr(map_closer, k) for k in ("batches", "candidates", "padded")] + [reflector_mod.solves]
    recomputes = slam.tracker.cache.recomputes
    slam.warm_up(buckets=(8,), new_keyframes=4, new_closures=4)
    assert [getattr(map_closer, k) for k in ("batches", "candidates", "padded")] + [reflector_mod.solves] == counts
    assert slam.tracker.cache.recomputes == recomputes
    for n, T in zip(slam.manager.nodes, poses):
        np.testing.assert_array_equal(n.transform, T)
    _same_relations(_relations(slam.manager), rels)
