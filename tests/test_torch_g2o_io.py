"""PyTorch port: g2o files, the native tokenizer, the simulators, boss tools
and the sensor synchronizer, against the JAX package.

Everything here is numpy on the host; the port's copies must give the
JAX package's results exactly:
- the native parse of a `write_g2o` file equals the Python parse field by
  field, and both equal JAX's `read_g2o`, for an SE2 landmark world, an SE3
  world and an SE3 world with EDGE_SE3_PRIOR records (which take the
  Python parser in both packages);
- `write_g2o` files are byte-equal to the JAX package's, and a
  write -> read -> write round trip is byte-equal;
- the native library builds into ``g2o_frontend_tpu_torch/_build/``, never
  beside its source, and a failed build raises with the compiler's output;
- `simulate`, `simulate_laser_world` and `simulate_se3` give JAX's worlds
  (`simulate_se3` on the unpadded prefix of JAX's padded graph);
- `boss_tools` (inspect, sync, playback, to-graph-se2, add-imu) prints the
  same JSON and writes the same files as JAX's; the synchronizer cases of
  tests/test_sensors_merger_sim.py give the same frames and drop counts.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from g2o_frontend_tpu.apps import boss_tools as jboss_tools
from g2o_frontend_tpu.io import boss as jboss
from g2o_frontend_tpu.io import g2o as jg2o
from g2o_frontend_tpu.io import sensors as jsensors
from g2o_frontend_tpu.slam import simulator as jsim
from g2o_frontend_tpu_torch import native
from g2o_frontend_tpu_torch.apps import boss_tools as tboss_tools
from g2o_frontend_tpu_torch.io import g2o as tg2o
from g2o_frontend_tpu_torch.io import sensors as tsensors
from g2o_frontend_tpu_torch.slam import simulator as tsim

SE3_SIM = dict(n_poses=40, seed=0, world_size=8.0, closure_min_gap=10, closure_radius=2.5, closure_prob=0.9)


def _assert_logs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.shape == y.shape and np.array_equal(x, y), f.name
        elif f.name == "params_se3_offset":
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        else:
            assert len(x) == len(y), f.name


def _se3_log():
    """An SE3 G2OLog of the port's simulated 3D world."""
    g, _ = tsim.simulate_se3(tsim.Simulator3DConfig(**SE3_SIM), device="cpu")
    n, e = g.poses.shape[0], g.pp_ij.shape[0]
    return tg2o.G2OLog(se3_ids=np.arange(n), se3_poses=g.poses.double().numpy(),
                       edge_se3_ij=g.pp_ij.numpy(), edge_se3_meas=g.pp_meas.double().numpy(),
                       edge_se3_info=g.pp_info.double().numpy(), fixed_ids=np.array([0]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("g2o")
    out = {"se2": d / "world.g2o", "se3": d / "se3.g2o", "prior": d / "prior.g2o"}
    tg2o.write_g2o(out["se2"], tsim.simulate(tsim.SimulatorConfig()).to_g2o_log())
    tg2o.write_g2o(out["se3"], _se3_log())
    with contextlib.redirect_stdout(io.StringIO()):
        tboss_tools.main(["add-imu", str(out["se3"]), "-o", str(out["prior"]), "--synthesize"])
    return out


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_native_parse_equals_python_and_jax(files, kind):
    path = files[kind]
    fast = tg2o._read_g2o_native(str(path))
    assert fast is not None
    _assert_logs_equal(fast, tg2o.read_g2o(path, native=False))
    _assert_logs_equal(fast, jg2o.read_g2o(path))
    _assert_logs_equal(tg2o.read_g2o(path), fast)
    n = len(fast.se2_ids) or len(fast.se3_ids)
    assert n == 200 if kind == "se2" else n == 40
    if kind == "se2":
        assert len(fast.xy_ids) == 80 and len(fast.edge_se2xy_ij) > 0


def test_prior_records_take_the_python_parser(files):
    path = files["prior"]
    assert tg2o._read_g2o_native(str(path)) is None
    log = tg2o.read_g2o(path)
    assert len(log.prior_se3_ids) == 40
    _assert_logs_equal(log, jg2o.read_g2o(path))


@pytest.mark.parametrize("kind", ["se2", "se3", "prior"])
def test_write_is_byte_equal_to_jax(files, kind, tmp_path):
    log = tg2o.read_g2o(files[kind])
    tg2o.write_g2o(tmp_path / "t.g2o", log)
    jg2o.write_g2o(tmp_path / "j.g2o", jg2o.read_g2o(files[kind]))
    assert (tmp_path / "t.g2o").read_bytes() == (tmp_path / "j.g2o").read_bytes() == files[kind].read_bytes()


def test_native_build_goes_to_build_dir():
    lib = native.build()
    assert lib.parent.parent == native.BUILD_DIR and native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == "g2o_frontend_tpu_torch"
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert native.load_library().fastg2o_abi() == native.ABI


def test_native_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "fastg2o.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on fastg2o.cpp"):
        native.build()


def test_simulate_matches_jax():
    for cfg in (tsim.SimulatorConfig(), tsim.SimulatorConfig(n_poses=300, n_landmarks=20, seed=3)):
        wt, wj = tsim.simulate(cfg), jsim.simulate(jsim.SimulatorConfig(**dataclasses.asdict(cfg)))
        np.testing.assert_array_equal(wt.gt_poses, wj.gt_poses)
        np.testing.assert_array_equal(wt.noisy_init(), wj.noisy_init())
        assert len(wt.closure_edges) == len(wj.closure_edges) and len(wt.observations) == len(wj.observations)
        _assert_logs_equal(wt.to_g2o_log(), wj.to_g2o_log())
        _assert_logs_equal(wt.to_g2o_log(with_landmarks=False, use_gt=True),
                           wj.to_g2o_log(with_landmarks=False, use_gt=True))
    lt, lj = tsim.simulate_laser_world(tsim.LaserWorldConfig(n_poses=20)), jsim.simulate_laser_world(
        jsim.LaserWorldConfig(n_poses=20))
    for k in ("gt_poses", "odom_deltas", "segments"):
        np.testing.assert_array_equal(lt[k], lj[k])
    for (rt, at), (rj, aj) in zip(lt["scans"], lj["scans"]):
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(at, aj)


def test_simulate_se3_matches_jax():
    gt, it = tsim.simulate_se3(tsim.Simulator3DConfig(**SE3_SIM), device="cpu")
    gj, ij = jsim.simulate_se3(jsim.Simulator3DConfig(**SE3_SIM))
    assert it["n_closures"] == ij["n_closures"] >= 2 and it["n_edges"] == ij["n_edges"]
    n, e = it["n_poses"], it["n_edges"]
    assert gt.poses.shape == (n, 7) and gt.pp_ij.shape == (e, 2) and gt.pp_ij.dtype == torch.int64
    for name in ("poses", "pose_mask", "fixed"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name))[:n])
    for name in ("pp_ij", "pp_meas", "pp_info", "pp_mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name))[:e])
    np.testing.assert_array_equal(it["init_T"], ij["init_T"])


# -- boss tools and the synchronizer ------------------------------------------------------


def _write_log(boss, path):
    """The log of tests/test_boss_tools_calib.py::_write_log."""
    with boss.Serializer(str(path)) as s:
        for k in range(6):
            s.write({"#class": "Msg", "topic": "/a", "timestamp": float(k)})
            s.write({"#class": "Msg", "topic": "/b", "timestamp": float(k) + 0.01})


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(line) for line in out.getvalue().strip().splitlines()]


@pytest.mark.parametrize("cmd", ["inspect", "sync", "playback"])
def test_boss_tools_match_jax(cmd, tmp_path):
    logs = {}
    for name, boss, main in (("t", None, tboss_tools.main), ("j", jboss, jboss_tools.main)):
        path = tmp_path / f"{name}.boss"
        _write_log(boss or tboss_tools.boss, path)
        extra = {"inspect": [], "sync": ["-o", str(tmp_path / f"{name}_sync.boss"), "-t", "/a", "-t", "/b", "--dt",
                                         "0.05"], "playback": ["--rate", "0"]}[cmd]
        logs[name] = _run(main, [cmd, str(path), *extra])
    if cmd == "sync":
        for name in "tj":
            assert logs[name][0].pop("output").endswith(f"{name}_sync.boss")
        assert (tmp_path / "t_sync.boss").read_bytes() == (tmp_path / "j_sync.boss").read_bytes()
        assert logs["t"][0]["frames"] == 6
    assert logs["t"] == logs["j"]


@pytest.mark.parametrize("cmd", ["to-graph-se2", "add-imu"])
def test_graph_tools_match_jax(files, cmd, tmp_path):
    extra = ["--synthesize"] if cmd == "add-imu" else []
    rt = _run(tboss_tools.main, [cmd, str(files["se3"]), "-o", str(tmp_path / "t.g2o"), *extra])[0]
    rj = _run(jboss_tools.main, [cmd, str(files["se3"]), "-o", str(tmp_path / "j.g2o"), *extra])[0]
    assert rt.pop("output").endswith("t.g2o") and rj.pop("output").endswith("j.g2o")
    assert rt == rj
    assert (tmp_path / "t.g2o").read_bytes() == (tmp_path / "j.g2o").read_bytes()


def _sync_cases(s):
    """The four cases of tests/test_sensors_merger_sim.py::TestSynchronizer,
    with module `s`: their frames, drop counts and sensor offsets."""
    out = []
    sync = s.SensorDataSynchronizer(["depth", "imu"])
    sync.add_sync_time_condition("depth", "imu", 0.05)
    out += [sync.process(s.SensorData("depth", 1.00, "d0")), sync.process(s.SensorData("imu", 1.02, "i0"))]
    sync = s.SensorDataSynchronizer(["a", "b"])
    sync.add_sync_time_condition("a", "b", 0.01)
    out += [sync.process(s.SensorData("a", 1.0)), sync.process(s.SensorData("b", 2.0))]
    sync = s.SensorDataSynchronizer(["a", "b"])
    sync.add_sync_time_condition("a", "b", 0.05)
    out += [sync.process(s.SensorData("a", 1.0)), sync.process(s.SensorData("a", 2.0)), sync.dropped,
            sync.process(s.SensorData("b", 2.01))]
    rc = s.RobotConfiguration()
    rc.add_sensor(s.Sensor(topic="/kinect", offset=[0.1, 0, 0.3, 0, 0, 0, 1]))
    out += [rc.sensor_offset("/kinect"), rc.sensor_offset("/unknown")]
    imu = s.IMUData(orientation=[0.0, 0.0, 0.6, 0.8])
    return out + [imu.quaternion()]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "topic") and hasattr(x, "timestamp"):
        return (x.topic, x.timestamp, x.payload)
    return x.tolist() if isinstance(x, np.ndarray) else x


def test_synchronizer_matches_jax():
    t, j = _sync_cases(tsensors), _sync_cases(jsensors)
    assert [_plain(x) for x in t] == [_plain(x) for x in j]
    assert t[1] is not None and t[1]["depth"].payload == "d0" and t[3] is None and t[6] == 1
