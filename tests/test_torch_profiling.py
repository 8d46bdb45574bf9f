"""PyTorch port: utils/profiling.py against the JAX package's, and the
device defaults of the port's entry points.

- `CumulativeTimer`: counts, sums and means equal to JAX's over the same
  sequence of calls, on one fake clock (exact);
- `device_time` and `in_turns` on CPU tensors: finite times > 0 (the host
  clock; CUDA graph replays are timed on the card by the probe app);
- `trace` writes a Chrome trace file;
- every public function or class of the port that takes `device` defaults
  to "cuda", and so does every command line's ``--device``.
"""
import importlib
import inspect
import math
import pkgutil
import time

import pytest
import torch

import g2o_frontend_tpu_torch
from g2o_frontend_tpu.utils import profiling as jprof
from g2o_frontend_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


def test_cumulative_timer_matches_jax(monkeypatch):
    """The same calls, one of them raising, on the same fake clock."""
    steps = [0.5, 0.25, 2.0, 0.125, 1.0]

    def run(timer_cls):
        ticks = iter([t for s in steps for t in (0.0, s)])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = timer_cls()
        assert timer.mean == 0.0
        for k in range(len(steps)):
            try:
                with timer():
                    if k == 2:
                        raise KeyError(k)
            except KeyError:
                pass
        return timer.num_calls, timer.cum_time, timer.mean

    port, jax_ = run(tprof.CumulativeTimer), run(jprof.CumulativeTimer)
    assert port == jax_ == (5, sum(steps), sum(steps) / 5)


def test_device_time_on_cpu():
    a = torch.rand(128, 128)
    t = tprof.device_time(lambda x, y: x @ y, [a, a], n=20, reps=3)
    assert math.isfinite(t) and t > 0
    assert all(math.isfinite(ms) and ms > 0 for ms in tprof.in_turns(lambda: a @ a, lambda: a + a, a, n=8))
    with pytest.raises(ValueError):
        tprof.device_time(lambda x: x, [a.to("meta")])


def test_trace_writes_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tb"):
        (torch.rand(64, 64) @ torch.rand(64, 64)).sum()
    traces = list((tmp_path / "tb").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


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
                 "convert.ba_problem_from_numpy", "convert.likelihood_map_from_numpy"):
        assert f"g2o_frontend_tpu_torch.{name}" in found, name
