"""PyTorch port: grid SLAM's per-scan matching as the JAX package compiles
it, on the CPU: `build_likelihood_map`, `correlative_match` and
`correlative_match_multires` (``laser/scan_matcher.py``) and
`gradient_refine` (``laser/matcher_refine.py``) as ``utils/graphs.Stage``s,
keyed by their static arguments and shapes as the JAX package keys its
jits.

- Each stage (``tools/graph_probe.py``'s `grid_stage_cases`) with the CUDA
  graph replaced by a stand-in that reruns the body
  (``tests/test_torch_solver_graphs.stand_in``): bit-equal to its eager
  body at every call, one capture a key; `gradient_refine` captures a key
  at its second call (its scans are unpadded, so a point count seen once
  keeps no graph).
- `GridSlam2D` over 45 scans of a simulated laser world, with and without
  the gradient polish, through the stand-ins: bit-equal to the plain CPU
  run (poses, edges, the optimized poses), and its keys: the match and
  loop-closure radii times the scans' point buckets, and the submaps'
  point buckets (at least 1,024 points).
- On the CPU, and in "eager" mode, the stages run their bodies.

The JAX parity of these functions is `tests/test_torch_laser.py`'s and
`tests/test_torch_grid_slam.py`'s; the card's runs are
``tools/graph_probe.py --grid`` and ``chip_smoke.py`` phase 14 (a).
"""
import numpy as np
import torch

from g2o_frontend_tpu_torch import models
from g2o_frontend_tpu_torch.laser import matcher_refine as mr
from g2o_frontend_tpu_torch.laser import scan_matcher as sm
from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world
from g2o_frontend_tpu_torch.utils import graphs
from tests.test_torch_solver_graphs import bits, stand_in  # noqa: F401  (a fixture)
from tools import graph_probe

torch.set_num_threads(1)

STAGES = (sm._LIKELIHOOD, sm._MATCH, sm._MULTIRES, mr._REFINE)


def tensors_of(x):
    return graphs.flatten(x)[1]


def fresh(monkeypatch):
    for stage in STAGES:
        monkeypatch.setattr(stage, "_graphs", {})
        monkeypatch.setattr(stage, "_seen", set())


def test_grid_stages_equal_their_bodies(stand_in, monkeypatch):
    fresh(monkeypatch)
    cases = graph_probe.grid_stage_cases(torch.device("cpu"))
    for name, (stage, body) in cases.items():
        want = tensors_of(body())
        for _ in range(3):
            assert bits(*zip(tensors_of(stage()), want)), name
    # one capture a key: the map, the match, the multires match at two radii, the refinement at its second call
    assert stand_in["stage_captures"] == len(cases)
    assert [len(s._graphs) for s in STAGES] == [1, 1, 2, 1]


def test_gradient_refine_captures_a_key_at_its_second_call(stand_in, monkeypatch):
    fresh(monkeypatch)
    stage, body = graph_probe.grid_stage_cases(torch.device("cpu"))["gradient_refine"]
    want = tensors_of(body())
    first = tensors_of(stage())
    assert stand_in["stage_captures"] == 0 and not mr._REFINE._graphs
    second, third = tensors_of(stage()), tensors_of(stage())
    assert stand_in["stage_captures"] == 1 and len(mr._REFINE._graphs) == 1
    assert bits(*zip(first, want)) and bits(*zip(second, want)) and bits(*zip(third, want))


def run(world, n, **cfg):
    slam = models.build("grid_slam", device="cpu", map_half_size=10.0, scans_per_submap=15, min_match_score=30.0,
                        **cfg)
    for k in range(n):
        slam.process_scan(*world["scans"][k], world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32))
    chi2 = slam.optimize(iters=4, cg_iters=40)
    return slam, chi2


def test_grid_slam_through_the_stand_ins_equals_the_plain_run(stand_in, monkeypatch):
    world = simulate_laser_world(LaserWorldConfig(n_poses=45, n_beams=360, room=6.0, max_range=16.0,
                                                  odom_noise=(0.08, 0.05, 0.02), seed=0))
    for polish in (0, 2):
        with graphs.mode("eager"):  # every stage and solve its body
            plain, chi2 = run(world, 45, gradient_polish_steps=polish)
        fresh(monkeypatch)
        graphed, chi2_g = run(world, 45, gradient_polish_steps=polish)
        assert chi2 == chi2_g
        assert np.array_equal(np.asarray(plain.poses), np.asarray(graphed.poses))
        assert len(plain.edges) == len(graphed.edges)
        for (i, j, z, w), (i2, j2, z2, w2) in zip(plain.edges, graphed.edges):
            assert (i, j) == (i2, j2) and np.array_equal(z, z2) and np.array_equal(w, w2)
        # the JAX package's keys: the match and loop radii by the scans' bucket, the submaps' point buckets
        radii = {d[1][5][2] for d in sm._MULTIRES._graphs}
        assert radii <= {int(r / 0.05) for r in (plain.cfg.search_radius_m, plain.cfg.loop_search_radius_m)}
        assert {d[1][1][1][0] for d in sm._MULTIRES._graphs} == {512}
        caps = sorted(d[1][0][1][0] for d in sm._LIKELIHOOD._graphs)
        assert caps and caps[0] >= 1024 and all(c & (c - 1) == 0 for c in caps)
        # the polish keys on the scans' exact point counts: only a count seen twice is captured
        if polish:
            assert mr._REFINE._seen and len(mr._REFINE._graphs) <= len(mr._REFINE._seen)
        else:
            assert not mr._REFINE._seen and not mr._REFINE._graphs


def test_grid_stages_run_their_body_on_the_cpu():
    for name, (stage, body) in graph_probe.grid_stage_cases(torch.device("cpu")).items():
        assert bits(*zip(tensors_of(stage()), tensors_of(body()))), name
        with graphs.mode("eager"):
            assert bits(*zip(tensors_of(stage()), tensors_of(body()))), name
