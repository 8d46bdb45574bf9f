"""BENCHMARK.json against the benchmark's contract, and the files it
names found by name: configurations, traffic, drivers, limits, readers."""
import importlib
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(kind):
    entries = BENCH[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if isinstance(e.get(key), str) and kind != "end_to_end" and key != "source":
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configurations_are_files_under_paths():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/") and len(c["source"]) <= 200
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["precision"] == "float32"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_traffic_driver_and_limits_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    wl, c = harness.cell(BENCH, w["name"])
    traffic = harness.traffic(w["traffic"])
    drv = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    for fn in ("setup", "window", "judge", "control"):
        assert callable(getattr(drv, fn))
    assert harness.limits(w["name"])
    e2e = [m["name"] for m in harness.metrics_of(BENCH, "end_to_end", w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, "per_layer", w["name"])


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"frames_per_s", "frame_ms_p95", "solve_s.schur", "solve_s.dense", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_and_moves_a_reported_metric(m):
    assert callable(harness.layer_reader(m["name"]))
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])
