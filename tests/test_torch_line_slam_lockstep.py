"""PyTorch port: line SLAM with its graph padded as the JAX package pads it,
stepped scan by scan beside the JAX package's `LineSlam2D`, both on the
CPU in float32 (`tools/jax_line_slam_reference.lockstep`, over the
452-scan laser world of `chip_smoke.py` phase 14).

The record (ROADMAP.md section 3, "Not faults"): the two runs part only
where float32 rounding is amplified, never because a function of the port
computes something else on the same inputs.

- Each package extracting its own lines, they part at scan 1: the JAX
  package's jitted `extract_lines` rounds a degenerate segment's float32
  moments otherwise than its own op-by-op run, and the port's lines equal
  that op-by-op run's within 1e-6 there.
- Given the JAX package's lines at every scan, the two runs associate
  alike through scan 59. Solves 1-4 (scans 14, 29, 44, 59) on the same
  padded inputs agree within the tolerance that
  `tests/test_torch_landmark_graphs.py::test_landmark_solver_matches_jax`
  holds (poses and lines 1e-3, the chi2 trace rtol 1e-3), in both
  directions (the port on the JAX package's inputs, the JAX package on the
  port's); yet solve 4 turns the runs' 2.4e-6 m apart going in into 0.33 m
  coming out, and scan 60 associates otherwise.
"""
import importlib.util
import os

import pytest

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "jax_line_slam_reference.py")


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("jax_line_slam_reference", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_line_slam_lockstep_parts_at_the_jitted_extraction(tool):
    res = tool.lockstep(shared=False, float64=False, stop=True)
    first = res["first_extraction"]
    assert first["scan"] == 1 and first["gap"] > 0.1, first
    assert first["port_equals_jax_op_by_op"] and first["gap_op_by_op"] <= 1e-5, first
    assert res["first_association"]["scan"] == 1


def test_line_slam_lockstep_solves_agree_on_the_same_inputs(tool):
    res = tool.lockstep(shared=True, float64=True)
    assert res["first_extraction"]["port_equals_jax_op_by_op"]
    assert res["first_association"]["scan"] == 60, res["first_association"]
    solves = res["solves"]
    assert [s["poses"] for s in solves] == [15, 30, 45, 60]
    for s in solves:
        same = s["same_inputs"]
        assert s["lines_jax"] == s["lines_port"], s
        assert same["pose_gap"] <= 1e-3 and same["line_gap"] <= 1e-3 and same["trace_rtol"] <= 1e-3, s
        assert same["jax_on_port"] <= 1e-3, s
        # each float32 solve within the same distance of the JAX package's float64 solve
        assert max(same["jax_f32_to_f64"], same["port_f32_to_f64"]) <= 1e-3, s
    # the runs stay within 2.5e-4 m through solve 3; solve 4 amplifies a few micrometres going in
    assert all(s["out_gap"] <= 2.5e-4 for s in solves[:3])
    assert solves[3]["in_gap"] <= 1e-5 and solves[3]["out_gap"] >= 0.1, solves[3]
