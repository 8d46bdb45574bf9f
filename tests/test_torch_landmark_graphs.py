"""PyTorch port: tracker2d and the landmark solvers as the JAX package runs
them, on the CPU: graphs padded to its power-of-two capacity buckets, the
line, plane and BA LM loops through ``utils/graphs.solve_loop``, and the
per-frame functions it jits as ``utils/graphs.Stage``s.

Tolerances:
- (a) `make_line_graph`, `make_plane_graph` and `make_ba_problem` against
  their JAX counterparts: the same shapes, every padded array equal (floats
  as float32, bit for bit); tracker2d's `graph()` and its window subgraph
  (the graph each tracker hands `optimize_se2` at its first window solve,
  the JAX draws fed to the port): the same shapes, masks, indices and
  information equal, poses, landmarks and measurements within 1e-4;
- (b) `optimize_line_graph`, `optimize_plane_graph` and `optimize_ba` in
  the CPU's "masked" mode (CG in blocks of 1, 5, 16 and more than its cap
  of masked steps) bit-equal to their "eager" mode and to verbatim copies
  of their loops before this form (``tests/pre_graph_solvers.py``); on
  the same padded inputs against the JAX package's solvers: the chi2
  trace within rtol 1e-3, every padded row of poses and landmarks within
  atol 1e-3; with the CUDA graph replaced by a stand-in that reruns the
  captured function (``tests/test_torch_solver_graphs.StandIn``), the
  captured paths bit-equal too, one host read a CG block and one a solve,
  launch counts under replay equal to the masked run's;
- (c) tracker2d over a 200-frame simulated world with the world2000
  recipe, the JAX draws fed to the port: the associations equal up to the
  first window solve, and the set of graph shapes handed to the solvers
  (window and global solves, covariances) equal to the JAX tracker's set
  on the same log, at most a handful;
- (d) each new stage (`_associate_nn`, `_associate_nn_mahal`, the RANSAC
  of ``ransac/engine.py``, `constellation._score_hypotheses`,
  `extract_lines`) through the stand-in capture bit-equal to its eager
  body, captured once a key (the RANSAC at a key's second call, so a key
  called once keeps no graph); the padded hypothesis scoring against the
  scoring at exact counts (counts equal, errors within rtol 1e-6); a
  tracker run through the stand-ins bit-equal to the plain run;
- (e) on the card: every new stage and solve replayed against its eager
  body and mode, bit for bit (``tools/graph_probe.py``'s `landmark_cases`
  and `check_landmark_stages`), in ``tests/test_torch_solver_graphs.py``,
  which imports no JAX (skipped here).
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from g2o_frontend_tpu.solvers import ba as jba
from g2o_frontend_tpu.solvers import line_slam as jls
from g2o_frontend_tpu.solvers import plane_slam as jps
from g2o_frontend_tpu_torch import convert, models
from g2o_frontend_tpu_torch.apps import tracker2d
from g2o_frontend_tpu_torch.graph.store import PoseGraph2D
from g2o_frontend_tpu_torch.io.g2o import read_g2o
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.slam import constellation as tcon
from g2o_frontend_tpu_torch.slam import feature_tracker as tft
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu_torch.solvers import ba as tba
from g2o_frontend_tpu_torch.solvers import line_slam as tls
from g2o_frontend_tpu_torch.solvers import pcg
from g2o_frontend_tpu_torch.solvers import plane_slam as tps
from g2o_frontend_tpu_torch.utils import graphs
from tests import pre_graph_solvers as pre
from tests.test_torch_feature_tracker import _trackers, _world
from tests.test_torch_line_slam import _problem
from tests.test_torch_solver_graphs import bits, stand_in  # noqa: F401  (a fixture)
from tools import graph_probe

torch.set_num_threads(1)


def jax_arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def same_padded(port, arrays):
    """Every field of `port` of the JAX arrays' shape and equal: bools and
    indices, floats as float32 bit for bit."""
    for name, a in arrays.items():
        b = getattr(port, name).numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)


# -- the problems -----------------------------------------------------------------------


def line_problem():
    _, _, poses_init, lines_init, pp, pl = _problem()
    return (poses_init, lines_init, pp, pl)


def plane_problem():
    _, _, poses7, planes_init, pp, pl = chip_smoke.plane_world(n_poses=40, planes=chip_smoke.random_planes(12, 4),
                                                               per_pose=4, step=0.05, seed=5)
    return (poses7, planes_init, pp, pl)


def ba_problem():
    _, _, poses7, points_init, (ij, z, w) = chip_smoke.ba_world(n_poses=20, n_points=200, per_point=5, seed=3)
    return (poses7, points_init, [(int(a), int(b), zz, ww) for (a, b), zz, ww in zip(ij, z, w)])


# name -> (problem, the JAX builder, the port's builder, the JAX solver, the port's, its copy before
# solve_loop, the caps)
SOLVERS = {
    "line": (line_problem, jls.make_line_graph, tls.make_line_graph, jls.optimize_line_graph,
             tls.optimize_line_graph, pre.optimize_line_graph, dict(iters=8, cg_iters=50)),
    "plane": (plane_problem, jps.make_plane_graph, tps.make_plane_graph, jps.optimize_plane_graph,
              tps.optimize_plane_graph, pre.optimize_plane_graph, dict(iters=6, cg_iters=60)),
    "ba": (ba_problem, jba.make_ba_problem, tba.make_ba_problem, jba.optimize_ba, tba.optimize_ba,
           pre.optimize_ba, dict(iters=6, cg_iters=40)),
}


@pytest.fixture(scope="module")
def problems():
    return {name: case[0]() for name, case in SOLVERS.items()}


def port_graph(problems, name):
    return SOLVERS[name][2](*problems[name], device="cpu")


def leaves(out):
    """Every tensor of a landmark solver's (graph, trace)."""
    g, trace = out
    return [t for t in g if torch.is_tensor(t)] + [trace]


# -- (a) the padded builders --------------------------------------------------------------


@pytest.mark.parametrize("name", list(SOLVERS))
def test_padded_builders_equal_jax(problems, name):
    problem, jax_make, port_make = problems[name], SOLVERS[name][1], SOLVERS[name][2]
    arrays = jax_arrays(jax_make(*problem))
    port = port_make(*problem, device="cpu")
    same_padded(port, arrays)
    n = len(problem[0])
    assert port.poses.shape[0] == max(8, 1 << (n - 1).bit_length()) > n  # padded to the next power of two
    assert not port.pose_mask[n:].any() and not port.fixed[n:].any()
    carried = {"line": convert.line_graph_from_numpy, "plane": convert.plane_graph_from_numpy,
               "ba": convert.ba_problem_from_numpy}[name](arrays, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(port, carried))
    if name == "ba":  # the arrays form of the observations
        poses7, points, obs = problem
        ij = np.array([o[:2] for o in obs]), np.array([o[2] for o in obs]), np.array([o[3] for o in obs])
        assert all(torch.equal(a, b) for a, b in zip(tba.make_ba_problem(poses7, points, ij, device="cpu"), port))


def test_plane_graph_without_odometry_edges_equals_jax(problems):
    """With no pose-pose edge the port gave the padded row a 7x7
    information (the measurement's width); the JAX package's is 6x6."""
    poses7, planes, _, pl = problems["plane"]
    same_padded(tps.make_plane_graph(poses7, planes, [], pl, device="cpu"),
                jax_arrays(jps.make_plane_graph(poses7, planes, [], pl)))


def graph_arrays(g):
    names = [f.name for f in dataclasses.fields(PoseGraph2D)]
    return {name: np.asarray(getattr(g, name)) for name in names}


def recorder(into):
    """A wrapper of a solver that records its graph argument's arrays."""

    def wrap(fn):
        def call(g, *args, **kwargs):
            into.append(graph_arrays(g))
            return fn(g, *args, **kwargs)

        return call

    return wrap


def test_tracker_graphs_equal_jax(monkeypatch):
    """tracker2d's window subgraph (the first window solve) and its global
    `graph()` against the JAX tracker's, the JAX draws fed to the port."""
    from g2o_frontend_tpu.solvers import pose_graph as jpg
    from g2o_frontend_tpu_torch.solvers import pose_graph as tpg

    gt, _, deltas, obs = _world()
    jt, tt = _trackers(min_landmark_creation_frames=2, optimize_each_n=10)
    windows_j, windows_t = [], []
    monkeypatch.setattr(jpg, "optimize_se2", recorder(windows_j)(jpg.optimize_se2))
    monkeypatch.setattr(tpg, "optimize_se2", recorder(windows_t)(tpg.optimize_se2))
    for k in range(len(gt)):
        d = np.zeros(3, np.float32) if k == 0 else deltas[k - 1]
        np.testing.assert_array_equal(tt.process_frame(d, obs[k]), jt.process_frame(d, obs[k]), err_msg=f"frame {k}")
    assert len(windows_t) == len(windows_j) == len(gt) // 10
    for name, a in windows_j[0].items():  # the first window, before any solve moved a pose
        b = windows_t[0][name]
        assert a.shape == b.shape, name
        if name in ("poses", "landmarks", "pp_meas", "pl_meas"):
            np.testing.assert_allclose(b, a, atol=1e-4, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=name)
    assert [{k: v.shape for k, v in w.items()} for w in windows_t] == [{k: v.shape for k, v in w.items()}
                                                                       for w in windows_j]
    gj, gt_ = graph_arrays(jt.graph()), graph_arrays(tt.graph())
    for name, a in gj.items():
        assert a.shape == gt_[name].shape, name
        if name in ("poses", "landmarks"):
            np.testing.assert_allclose(gt_[name], a, atol=1e-2, rtol=0, err_msg=name)
        elif name in ("pp_meas", "pl_meas", "pp_info", "pl_info"):
            np.testing.assert_allclose(gt_[name], a, atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(gt_[name], a.astype(gt_[name].dtype), err_msg=name)
    assert tt.graph().poses.shape[0] == 64 and tt.cfg.reserve_poses == 0  # 60 poses in a bucket of 64
    tt.cfg.reserve_poses = jt.cfg.reserve_poses = 200  # the reserve acts as in the JAX package
    assert tt.graph().poses.shape[0] == np.asarray(jt.graph().poses).shape[0] == 256


# -- (b) the LM solvers --------------------------------------------------------------------


@pytest.mark.parametrize("block", [1, 5, 16, 64])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_landmark_solver_equals_its_pre_graph_loop(monkeypatch, problems, name, block):
    """The masked steps change no bit after CG stops, for the (pose,
    landmark) block vector and BA's camera vector alike."""
    monkeypatch.setattr(pcg, "BLOCK", block)
    g, caps = port_graph(problems, name), SOLVERS[name][6]
    now, before = SOLVERS[name][4], SOLVERS[name][5]
    want = leaves(before(g, **caps))
    assert bits(*zip(leaves(now(g, **caps)), want))  # the CPU runs the masked blocks
    with graphs.mode("eager"):
        assert bits(*zip(leaves(now(g, **caps)), want))


@pytest.mark.parametrize("name", list(SOLVERS))
def test_landmark_solver_matches_jax(problems, name):
    problem, jax_make, _, jax_solve, port_solve, _, caps = SOLVERS[name]
    gj = jax_make(*problems[name])
    gt = {"line": convert.line_graph_from_numpy, "plane": convert.plane_graph_from_numpy,
          "ba": convert.ba_problem_from_numpy}[name](jax_arrays(gj), device="cpu")
    oj, trj = jax_solve(gj, **caps)
    ot, trt = port_solve(gt, **caps)
    np.testing.assert_allclose(trt.numpy(), np.asarray(trj), rtol=1e-3)
    for field in ("poses", {"line": "lines", "plane": "planes", "ba": "points"}[name]):
        a, b = np.asarray(getattr(oj, field)), getattr(ot, field).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-3, err_msg=field)
    assert float(trt[-1]) < 0.05 * float(trt[0])


@pytest.mark.parametrize("name", list(SOLVERS))
def test_landmark_captured_paths_equal_the_pre_graph_loop(stand_in, problems, name):
    g, caps = port_graph(problems, name), SOLVERS[name][6]
    now, before = SOLVERS[name][4], SOLVERS[name][5]
    want = leaves(before(g, **caps))
    first = leaves(now(g, **caps))  # a key seen once: head and tail eager, the CG blocks through _Blocks
    assert not any(kept for _, kept in stand_in["pieces"])
    second, third = leaves(now(g, **caps)), leaves(now(g, **caps))  # the chain captured, then replayed
    assert len([n for n, k in stand_in["pieces"] if k]) == 3
    assert bits(*zip(first, want)) and bits(*zip(second, want)) and bits(*zip(third, want))


@pytest.mark.parametrize("name", list(SOLVERS))
def test_landmark_host_reads_and_launches(stand_in, problems, name, monkeypatch):
    """One host read of the CG flag a block and one report a solve; the
    replayed solve counts the masked run's segment-sum launches."""
    g, caps = port_graph(problems, name), SOLVERS[name][6]
    solve = SOLVERS[name][4]
    real_bool, real_tolist = torch.Tensor.__bool__, torch.Tensor.tolist
    reads = []
    counts = []
    for mode in ("masked", "graph", "graph", "graph"):
        monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append("flag") or real_bool(t))
        monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append("report") or real_tolist(t))
        reads.clear()
        ss.launches = 0
        with graphs.mode(mode):
            solve(g, **caps)
        counts.append(ss.launches)
        monkeypatch.setattr(torch.Tensor, "__bool__", real_bool)
        monkeypatch.setattr(torch.Tensor, "tolist", real_tolist)
        assert reads.count("report") == 1
        assert reads.count("flag") <= caps["iters"] * -(-caps["cg_iters"] // pcg.BLOCK)
    assert counts[0] > 0 and counts == [counts[0]] * 4


def test_no_caller_of_the_eager_pcg_in_the_landmark_solvers():
    import inspect

    for mod in (tls, tba):
        assert "pcg(" not in inspect.getsource(mod).replace("cg_loop(", ""), mod.__name__


# -- (c) tracker2d's shapes over a simulated world -----------------------------------------


def shape_of(g):
    return tuple((f.name, tuple(np.asarray(getattr(g, f.name)).shape)) for f in dataclasses.fields(PoseGraph2D))


def test_tracker2d_hands_its_solvers_the_jax_shapes(monkeypatch, tmp_path):
    from g2o_frontend_tpu.solvers import pose_graph as jpg
    from g2o_frontend_tpu.solvers import schur_pcg as jsp
    from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
    from g2o_frontend_tpu_torch.solvers import schur_pcg as tsp

    world = simulate(SimulatorConfig(n_poses=200, n_landmarks=30, seed=0))
    path = str(tmp_path / "world200_noassoc.g2o")
    chip_smoke.write_noassoc_g2o(path, world)
    frames = list(tracker2d.frames_of(read_g2o(path)))
    cfg = models.TRACKER2D_RECIPES["world2000"]
    jt, tt = _trackers(**cfg)
    shapes = {"jax": [], "port": []}
    for key, mods in (("jax", (jpg, jsp)), ("port", (tpg, tsp))):
        for mod, fn in ((mods[0], "optimize_se2"), (mods[1], "landmark_covariance_se2")):
            real = getattr(mod, fn)
            monkeypatch.setattr(mod, fn, lambda g, *a, _real=real, _key=key, _fn=fn, **k:
                                shapes[_key].append((_fn, shape_of(g))) or _real(g, *a, **k))
    first_solve = cfg["optimize_each_n"] - 1
    for k, (delta, obs, info) in enumerate(frames):
        mj, mt = jt.process_frame(delta, obs, info), tt.process_frame(delta, obs, info)
        if k <= first_solve:
            np.testing.assert_array_equal(mt, mj, err_msg=f"frame {k}")
        if (k + 1) % 100 == 0:
            jt.close_loops(), tt.close_loops()
    for tr in (jt, tt):
        tr.optimize(local=False)
        tr.refresh_landmark_covariances()
        tr.optimize(local=False, iters=5)
    assert len(shapes["port"]) == len(shapes["jax"]) > len(frames) // cfg["optimize_each_n"]
    assert set(shapes["port"]) == set(shapes["jax"])
    assert len(set(shapes["port"])) <= 6, sorted(set(shapes["port"]))


# -- (d) the per-frame stages --------------------------------------------------------------


def tensors_of(x):
    return graphs.flatten(x)[1]


def test_stages_equal_their_bodies(stand_in):
    cases = graph_probe.stage_cases(torch.device("cpu"))
    for name, (stage, body) in cases.items():
        want = tensors_of(body())
        assert bits(*zip(tensors_of(stage()), want)), name
        assert bits(*zip(tensors_of(stage()), want)), name  # the key captured before: a replay
    assert stand_in["stage_captures"] == len(cases)  # one capture a key, both buckets of associate_nn
    found = tensors_of(cases["ransac"][0]())
    assert bool(found[-1]) and int(found[2]) == 8  # ok, the 8 inliers of 11 valid pairs


def test_ransac_captures_a_key_at_its_second_call(stand_in, monkeypatch):
    """`slam.graph_merge` calls the RANSAC at exact, varying shapes: a key
    called once keeps no graph; the tracker's padded keys repeat and
    replay."""
    from g2o_frontend_tpu_torch.ransac import engine as tengine

    monkeypatch.setattr(tengine._RANSAC, "_graphs", {})
    monkeypatch.setattr(tengine._RANSAC, "_seen", set())
    stage, body = graph_probe.stage_cases(torch.device("cpu"))["ransac"]
    want = tensors_of(body())
    first = tensors_of(stage())
    assert stand_in["stage_captures"] == 0 and not tengine._RANSAC._graphs
    second, third = tensors_of(stage()), tensors_of(stage())
    assert stand_in["stage_captures"] == 1 and len(tengine._RANSAC._graphs) == 1
    assert bits(*zip(first, want)) and bits(*zip(second, want)) and bits(*zip(third, want))


def test_stages_run_their_body_on_the_cpu():
    for name, (stage, body) in graph_probe.stage_cases(torch.device("cpu")).items():
        assert bits(*zip(tensors_of(stage()), tensors_of(body()))), name


def test_padded_scoring_equals_exact_counts():
    rng = np.random.default_rng(4)
    T = rng.uniform(-1, 1, (37, 3)).astype(np.float32)
    A, B = rng.uniform(-5, 5, (11, 2)).astype(np.float32), rng.uniform(-5, 5, (19, 2)).astype(np.float32)
    B[:11] = A + rng.normal(0, 0.1, A.shape)
    exact = tcon._score_hypotheses_body(torch.as_tensor(T), torch.as_tensor(A), torch.ones(11, dtype=torch.bool),
                                        torch.as_tensor(B), torch.ones(19, dtype=torch.bool), 1.0)
    Tp = np.zeros((64, 3), np.float32)
    Tp[:37], Tp[37:, :2] = T, 1e6
    Ap, Bp = np.zeros((16, 2), np.float32), np.zeros((32, 2), np.float32)
    Ap[:11], Bp[:19] = A, B
    padded = tcon._score_hypotheses(torch.as_tensor(Tp), torch.as_tensor(Ap), torch.as_tensor(np.arange(16) < 11),
                                    torch.as_tensor(Bp), torch.as_tensor(np.arange(32) < 19), 1.0)
    assert torch.equal(padded[0][:37], exact[0]) and not padded[0][37:].any() and exact[0].max() > 3
    np.testing.assert_allclose(padded[1][:37].numpy(), exact[1].numpy(), rtol=1e-6)


def test_tracker_through_the_stand_ins_equals_the_plain_run(stand_in):
    gt, _, deltas, obs = _world()
    runs = []
    for through_stand_ins in (False, True):
        tr = tft.FeatureTracker2D(tft.Tracker2DConfig(min_landmark_creation_frames=2, optimize_each_n=10),
                                  device="cpu")
        matched = []
        with graphs.mode("graph" if through_stand_ins else "masked"):
            for k in range(30):
                matched.append(tr.process_frame(np.zeros(3, np.float32) if k == 0 else deltas[k - 1], obs[k]))
        runs.append((np.concatenate(matched), tr.trajectory(), tr.landmarks.copy()))
        if not through_stand_ins:
            stand_in["stage_captures"] = 0
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    assert stand_in["stage_captures"] > 0 and any(kept for _, kept in stand_in["pieces"])
