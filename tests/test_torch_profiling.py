"""PyTorch port: utils/profiling.py, its spans where the port records
them, and the device defaults of the port's entry points.

- `device_time` and `in_turns` on CPU tensors: finite times > 0 (the host
  clock; CUDA graph replays are timed on the card by the probe app);
- `span`: nothing recorded outside a profiler session (torch's own flag,
  pinned), a span around an operation holds that operation's kineto event
  (one clock), a bounded buffer, parents and request ids from the stack;
  the tracker's frame, the scan, the Schur solve, the stages, the graph
  launches and the host reads where the port puts them; the replay
  counters of ``utils/graphs``, which leave out first replays and all
  from the first replay under a profiler on;
- `trace` writes a Chrome trace file with the spans on its time base;
- every public function or class of the port that takes `device` defaults
  to "cuda", and so does every command line's ``--device``;
- on the card (``-m cuda``; the machine there has no JAX: ``python3 -m
  pytest tests/test_torch_profiling.py -m cuda --noconftest``): in the
  live and Schur cells' traffic, every ``cudaGraphLaunch`` of a traced
  window inside a ``launch`` span, every host read's copy or sync inside
  its ``host_read`` span, and the Schur replays' host time before the
  profiler in tens of us (``tools/span_report.py``).
"""
import collections
import importlib
import inspect
import json
import math
import pkgutil
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import g2o_frontend_tpu_torch
from g2o_frontend_tpu_torch.apps import pwn_odometry
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.slam import pwn_tracker
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu_torch.solvers import schur_pcg
from g2o_frontend_tpu_torch.utils import graphs, synth
from g2o_frontend_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_device_time_on_cpu():
    a = torch.rand(128, 128)
    t = tprof.device_time(lambda x, y: x @ y, [a, a], n=20, reps=3)
    assert math.isfinite(t) and t > 0
    assert all(math.isfinite(ms) and ms > 0 for ms in tprof.in_turns(lambda: a @ a, lambda: a + a, a, n=8))
    with pytest.raises(ValueError):
        tprof.device_time(lambda x: x, [a.to("meta")])


def test_trace_writes_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tb"):
        with tprof.span("block", 5):
            (torch.rand(64, 64) @ torch.rand(64, 64)).sum()
    traces = list((tmp_path / "tb").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    doc = json.loads(traces[0].read_text())
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert [(e["name"], e["args"]["request"]) for e in mine] == [("block", 5)]
    # no card here: the host's operations, inside the span on the file's time base
    mm = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm and all(mine[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= mine[0]["ts"] + mine[0]["dur"] for e in mm)


def _port_modules():
    pkg = g2o_frontend_tpu_torch
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        yield importlib.import_module(info.name)


def test_entry_points_default_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    found = {}
    for mod in _port_modules():
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            if "device" in params:
                found[f"{mod.__name__}.{name}"] = params["device"].default
        if hasattr(mod, "_parser"):
            found[f"{mod.__name__} --device"] = mod._parser().get_default("device")
    assert {k: v for k, v in found.items() if v != "cuda"} == {}
    for name in ("convert.cloud_from_numpy", "convert.pose_graph3d_from_numpy", "utils.synth.render_planes_depth",
                 "slam.pwn_tracker.PwnTracker", "slam.pwn_tracker.odometry_scan", "graph.reflector.MapReflector",
                 "apps.pwn_odometry --device", "apps.pwn_slam --device", "apps.profile_gather --device",
                 "slam.feature_tracker.FeatureTracker2D", "slam.constellation.match_constellations",
                 "slam.graph_merge.match_graphs", "slam.graph_merge.merge_graphs", "slam.graph_merge.overlap_score",
                 "slam.graph_merge.map_entropy", "models.pwn_rgbd_odometry", "models.tracker2d",
                 "apps.tracker2d --device", "models.grid_slam", "models.line_slam", "slam.grid_slam.GridSlam2D",
                 "slam.line_slam.LineSlam2D", "solvers.line_slam.make_line_graph",
                 "solvers.line_slam.line_graph_from_log", "solvers.plane_slam.make_plane_graph",
                 "solvers.ba.make_ba_problem", "convert.line_graph_from_numpy", "convert.plane_graph_from_numpy",
                 "convert.ba_problem_from_numpy", "convert.likelihood_map_from_numpy", "entry.entry",
                 "entry.dryrun_multichip", "apps.bench --device", "apps.bench.bench_pwn_aligner",
                 "apps.bench.bench_tracker", "apps.bench.bench_se3_sim_distributed", "apps.evaluate --device",
                 "apps.evaluate.grid_slam_gt", "apps.evaluate.pwn_slam", "apps.evaluate.pwn_slam_long",
                 "apps.evaluate.stress_run", "apps.evaluate.pwn_odometry_tum", "apps.scan_witness --device"):
        assert f"g2o_frontend_tpu_torch.{name}" in found, name


# -- spans ---------------------------------------------------------------------------------


def test_no_span_is_recorded_outside_a_profiler_session():
    tprof.clear_spans()
    assert tprof.span("a") is tprof.span("b", 3)  # the shared no-op: nothing made
    with tprof.span("a", 1):
        with tprof.span("b"):
            torch.ones(2).add(1)
    assert tprof.spans() == []


def test_spans_record_while_torchs_profiler_flag_is_set():
    """The recorder reads ``torch.autograd.profiler._is_profiler_enabled``,
    which torch sets for a session of any activities and clears after."""
    from torch.autograd import profiler as autograd_profiler

    tprof.clear_spans()
    assert autograd_profiler._is_profiler_enabled is False
    with cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True
        with tprof.span("on", 2):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    with tprof.span("off"):
        pass
    assert [(s.name, s.request, s.parent) for s in tprof.spans()] == [("on", 2, -1)]


def test_a_span_holds_the_kineto_event_of_its_operation():
    """Spans and kineto's host events are on one clock."""
    tprof.clear_spans()
    x = torch.ones(16)
    with cpu_profile() as prof:
        with tprof.span("add"):
            x.add(1)
    (s,) = tprof.spans()
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add"]
    assert len(adds) == 1
    e = adds[0]
    assert s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
    assert s.end_ns - s.start_ns < 10**9  # the same epoch: not merely an enormous span


def test_span_buffer_keeps_the_last_spans_within_its_bound(monkeypatch):
    assert tprof._SPANS.maxlen == tprof.SPAN_CAPACITY == 2**20
    monkeypatch.setattr(tprof, "_SPANS", collections.deque(maxlen=5))
    with cpu_profile():
        for k in range(12):
            with tprof.span("s", k):
                pass
    got = tprof.spans()
    assert len(got) == 5 and [s.request for s in got] == list(range(7, 12))
    tprof.clear_spans()
    assert tprof.spans() == []


def test_parents_and_request_ids_come_from_the_stack():
    tprof.clear_spans()
    with cpu_profile():
        with tprof.span("outer", "r1"):
            with tprof.span("mid"):
                with tprof.span("inner", "r2"):
                    pass
            with tprof.span("next"):
                pass
        with tprof.span("alone"):
            pass
    by = {s.name: s for s in tprof.spans()}
    assert by["outer"].parent == -1 and by["alone"].parent == -1 and by["alone"].request is None
    assert by["mid"].parent == by["outer"].id and by["mid"].request == "r1"
    assert by["inner"].parent == by["mid"].id and by["inner"].request == "r2"
    assert by["next"].parent == by["outer"].id and by["next"].request == "r1"
    assert [s.name for s in tprof.spans()] == ["inner", "mid", "next", "outer", "alone"]  # in closing order
    assert by["outer"].start_ns <= by["mid"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns


@pytest.fixture(scope="module")
def tracked():
    """Five frames of the bench pair's scene at 60x80 on the CPU under a
    profile, twice: never a keyframe after the first (fraction 0), and
    always (fraction 1.1). (tracker, its spans) of each."""
    proj, ccfg, acfg = pwn_odometry.configs(8, "kinect")
    poses = [synth.lie.se3_exp(torch.tensor([0.01 * k, 0.0, 0.005 * k, 0.0, 0.01 * k, 0.0])).double().numpy()
             for k in range(5)]
    depths = [synth.render_planes_depth(T, proj, synth.BENCH_PLANES, device="cpu") for T in poses]
    out = {}
    for fraction in (0.0, 1.1):
        cfg = pwn_tracker.PwnTrackerConfig(new_frame_inliers_fraction=fraction, min_cloud_inliers=1)
        tr = pwn_tracker.PwnTracker(proj, ccfg, acfg, cfg, device="cpu")
        tprof.clear_spans()
        with cpu_profile():
            for d in depths:
                tr.process_frame(d.numpy())
        out[fraction] = (tr, tprof.spans())
    tprof.clear_spans()
    return out


def test_tracker_frame_spans_hold_the_host_reads_and_stages(tracked):
    seen = set()
    for tr, rec in tracked.values():
        frames = [s for s in rec if s.name == "pwn_tracker.frame"]
        assert [f.request for f in frames] == list(range(5)) and all(f.parent == -1 for f in frames)
        for f, m in zip(frames, tr.metrics):
            kids = [s.name for s in rec if s.parent == f.id]
            assert kids.count("upload") == 1 and kids.count("stage:depth_to_cloud") >= 1
            if f.request == 0:  # the first keyframe: nothing aligned, nothing read
                assert kids.count("host_read") == 0 and "stage:align" not in kids
                continue
            assert kids.count("stage:align") == 1
            assert kids.count("host_read") == (4 if m["keyframe"] else 3)
            seen.add(m["keyframe"])
    assert seen == {True, False}


def test_stage_spans_carry_their_frame_as_parent_and_request(tracked):
    _, rec = tracked[1.1]
    frames = {s.id: s for s in rec if s.name == "pwn_tracker.frame"}
    stages = [s for s in rec if s.name.startswith("stage:")]
    assert len(stages) >= 9
    for s in stages:
        assert s.parent in frames and s.request == frames[s.parent].request
        assert frames[s.parent].start_ns <= s.start_ns <= s.end_ns <= frames[s.parent].end_ns


def test_scan_spans_a_call_its_upload_and_each_step():
    proj, ccfg, acfg = pwn_odometry.configs(8, "kinect")
    raw = np.stack([(synth.bench_depth(np.eye(4), "cpu", 60, 80).numpy() * 5000).astype(np.uint16)] * 3)
    tprof.clear_spans()
    with cpu_profile():
        pwn_tracker.odometry_scan(raw, proj, ccfg, acfg, min_cloud_inliers=1, depth_scale=1 / 5000, device="cpu")
        pwn_tracker.odometry_scan(raw, proj, ccfg, acfg, min_cloud_inliers=1, depth_scale=1 / 5000, device="cpu")
    rec = tprof.spans()
    calls = [s for s in rec if s.name == "odometry_scan"]
    assert len(calls) == 2 and calls[1].request == calls[0].request + 1
    for c in calls:
        kids = collections.Counter(s.name for s in rec if s.parent == c.id)
        assert kids == {"upload": 1, "stage:depth_to_cloud": 1, "stage:odometry_scan step": 2}
        assert all(s.request == c.request for s in rec if s.parent == c.id)
    tprof.clear_spans()


def test_host_read_spans_count_what_host_reads_counts():
    world = simulate(SimulatorConfig(n_poses=40, n_landmarks=8, world_size=10.0, seed=4))
    g, _ = graph2d_from_log(world.to_g2o_log(), device="cpu")
    tprof.clear_spans()
    before = graphs.host_reads
    with cpu_profile(), graphs.mode("masked"):
        schur_pcg.optimize_se2_schur(g, iters=4, cg_iters=30, lm_lambda0=1e-3)
    reads = graphs.host_reads - before
    rec = tprof.spans()
    (solve,) = [s for s in rec if s.name == "solve:optimize_se2_schur"]
    got = [s for s in rec if s.name == "host_read"]
    assert reads > 4 and len(got) == reads
    assert all(s.parent == solve.id and s.request == solve.request for s in got)
    tprof.clear_spans()


def test_launch_spans_hold_each_graph_replay_alone():
    """`Graph.replay` and a solve piece's replay: the ``launch`` span is
    around ``CUDAGraph.replay()`` and nothing else (a stand-in graph here)."""
    at = []

    class Replays:
        def replay(self):
            at.append(time.time_ns())

    x = torch.zeros(3)
    g = graphs.Graph(Replays(), [torch.zeros(3)], [torch.ones(3)], graphs.key(x)[0][1][0], [0] * len(graphs.COUNTERS))
    piece = graphs._Piece(Replays(), None, [0] * len(graphs.COUNTERS))
    tprof.clear_spans()
    with cpu_profile():
        with tprof.span("stage:stand-in", 9):
            g.replay([x])
        piece.replay()
    launch = [s for s in tprof.spans() if s.name == "launch"]
    assert len(launch) == 2 == len(at)
    for s, t in zip(launch, at):
        assert s.start_ns <= t <= s.end_ns
    assert launch[0].request == 9 and launch[1].parent == -1
    tprof.clear_spans()


def test_replays_are_timed_but_a_graphs_first_and_none_from_a_profile_on(monkeypatch):
    """`graphs.replay_ns` and `replays`, always on: a stand-in graph's
    first replay uploads it on a card, and from the first replay under a
    profiler on the trace's cost lands in every replay; neither is
    counted."""

    class Replays:
        def replay(self):
            time.sleep(0.001)

    monkeypatch.setattr(graphs, "_profiled", False)
    x = torch.zeros(3)
    g = graphs.Graph(Replays(), [torch.zeros(3)], [torch.ones(3)], graphs.key(x)[0][1][0], [0] * len(graphs.COUNTERS))
    piece = graphs._Piece(Replays(), None, [0] * len(graphs.COUNTERS))
    ns, n = graphs.replay_ns, graphs.replays
    g.replay([x])
    piece.replay()
    assert (graphs.replay_ns, graphs.replays) == (ns, n)  # first replays
    for _ in range(3):
        g.replay([x])
    piece.replay()
    assert graphs.replays == n + 4 and graphs.replay_ns - ns >= 4 * 10**6
    ns, n = graphs.replay_ns, graphs.replays
    with cpu_profile():
        g.replay([x])
    g.replay([x])
    piece.replay()
    assert (graphs.replay_ns, graphs.replays) == (ns, n)  # under the profiler and after it
    tprof.clear_spans()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pwn_odom.live", "se2_schur.victoria"])
def test_graph_launches_and_host_reads_lie_inside_their_spans_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from tools import span_report

    rep = span_report.traced(workload, 2**31 + 77, 3.0)
    c, m = rep["clock"], rep["metrics"]
    assert rep["correct"], rep
    assert c["graph_launches"] > 0 and c["inside"] >= 0.99, c
    assert c["copies_and_syncs_in_host_reads"] > 0 and c["ending_after_their_read"] == 0, c
    name = "track" if workload.startswith("pwn") else "schur"
    assert 0 <= m[f"idle_program_pct.{name}"] <= m[f"device_idle_pct.{name}"], m
    if name == "schur":  # the warm-up's replays, before the profiler: tens of us, not the trace's
        assert 0 < m["launch_host_us.schur"] < 100, m
    else:
        # every host read of a frame syncs, and so does each upload
        assert c["syncs_in_frames"] >= c["host_read_spans"] > 0, c
        assert m["host_syncs_per_frame"] == pytest.approx(c["syncs_in_frames"] / rep["requests"]), (m, c)
