"""PyTorch port: the Schur-complement SE2 solver, the landmark covariance,
padded graphs carried from JAX, and the SE3 solver on bench.py's simulated
world, against the JAX package.

Graphs: tests/test_schur_pcg.py's chain with landmarks (padded and
unpadded), tests/test_partitioned.py's pose-only ring, the default
`simulate()` world (200 poses, 80 landmarks) and bench.py's 300-pose
`simulate_se3` world (seed 0, the configuration of its SE3 gate). Both
packages run on the CPU in float32.

Tolerances:
- `optimize_se2_schur` (Woodbury arrow and Schur-corrected chain, and a
  pose-only graph): poses and landmarks within atol 1e-4, the final chi2
  within rtol 1e-4, the chi2 trace within rtol 2e-3; where JAX reaches
  1.01x `control_optimize_se2`, so does the port. The trace's rtol is wider
  than 1e-3 for the first step on the chain-landmark graph, a float32 solve
  of a system of condition ~9e5 at lambda 1e-6 (as in
  tests/test_torch_se2.py's dense solve): with the Woodbury arrow JAX's
  step gives chi2 259.12, the port's 259.48, the port's in float64 259.23
  (both within 0.1% of it, 0.14% apart);
- `landmark_covariance_se2`: within 1e-3 of the largest entry of JAX's, on
  the unpadded prefix; each diagonal block symmetric within 1e-4 of the
  largest entry (float32 inverse of the capacitance) and positive
  definite;
- a padded JAX graph carried across solves to the exact-size result:
  poses and landmarks within atol 1e-4, the final chi2 within rtol 1e-4,
  the trace within rtol 2e-3 (the first dense step: the padded system's
  identity rows change the float32 Cholesky's rounding, 259.44 against
  259.86);
- `optimize_se3` on bench.py's world: the graph equal to JAX's simulator's
  on its unpadded prefix, the final chi2 within rtol 1e-3 of JAX's; the
  chain preconditioner reaches 1.01x `control_optimize_se3` in JAX (10 LM
  iterations) and so in the port; the Jacobi one does not in JAX (1.020x),
  and its ratio is only reported.
"""
import dataclasses

import numpy as np
import pytest
import torch

from g2o_frontend_tpu.graph.store import graph2d_from_log as jgraph2d_from_log
from g2o_frontend_tpu.slam.simulator import Simulator3DConfig, SimulatorConfig, simulate, simulate_se3
from g2o_frontend_tpu.solvers import pose_graph as jpg
from g2o_frontend_tpu.solvers import schur_pcg as jsp
from g2o_frontend_tpu.solvers.control import control_optimize_se2, control_optimize_se3
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.slam import simulator as tsim
from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
from g2o_frontend_tpu_torch.solvers import schur_pcg as tsp
from tests.test_partitioned import _ring_graph
from tests.test_schur_pcg import _chain_landmark_graph
from tests.test_torch_se2 import jax_graph_to_port

torch.set_num_threads(1)

BENCH_SE3 = dict(n_poses=300, seed=0, world_size=20.0, closure_min_gap=50, closure_radius=3.5, closure_prob=0.9)


def _prefix(a, like):
    return np.asarray(a)[: like.shape[0]]


@pytest.fixture(scope="module")
def graphs():
    world = simulate(SimulatorConfig()).to_g2o_log()
    out = {"world": (jgraph2d_from_log(world)[0], graph2d_from_log(world, device="cpu")[0])}
    for name, gj in (("chain", _chain_landmark_graph()), ("chain_padded", _chain_landmark_graph(pad=True)),
                     ("ring", _ring_graph())):
        out[name] = (gj, jax_graph_to_port(gj))
    return out


@pytest.mark.parametrize("name, woodbury", [("chain", True), ("chain", False), ("world", None), ("world", False),
                                            ("ring", None)])
def test_optimize_se2_schur_matches_jax(graphs, name, woodbury):
    gj, gt = graphs[name]
    kw = dict(iters=8, cg_iters=120, woodbury=woodbury)
    gj_opt, sj = jsp.optimize_se2_schur(gj, **kw)
    gt_opt, st = tsp.optimize_se2_schur(gt, **kw)
    np.testing.assert_allclose(st.chi2.numpy(), np.asarray(sj.chi2), rtol=2e-3)
    np.testing.assert_allclose(float(st.chi2[-1]), float(sj.chi2[-1]), rtol=1e-4)
    np.testing.assert_allclose(gt_opt.poses.numpy(), _prefix(gj_opt.poses, gt_opt.poses), atol=1e-4)
    np.testing.assert_allclose(gt_opt.landmarks.numpy(), _prefix(gj_opt.landmarks, gt_opt.landmarks), atol=1e-4)
    ctl = control_optimize_se2(gj)["chi2"]
    if float(sj.chi2[-1]) <= 1.01 * ctl:
        assert float(st.chi2[-1]) <= 1.01 * ctl
    assert 0 < st.lm_iters <= 8 and st.cg_iters > 0


def test_landmark_covariance_matches_jax(graphs):
    for name in ("chain", "world"):
        gj, gt = graphs[name]
        cj = np.asarray(jsp.landmark_covariance_se2(gj, lam=1e-9))
        ct = tsp.landmark_covariance_se2(gt, lam=1e-9)
        n = gt.landmarks.shape[0]
        assert ct.shape == (n, 2, n, 2) and torch.isfinite(ct).all()
        cj = cj[:n, :, :n, :]
        np.testing.assert_allclose(ct.numpy(), cj, atol=1e-3 * np.abs(cj).max())
        blocks = ct.numpy()[np.arange(n), :, np.arange(n), :]
        np.testing.assert_allclose(blocks, np.swapaxes(blocks, 1, 2), atol=1e-4 * np.abs(blocks).max())
        assert (np.linalg.eigvalsh(blocks.astype(np.float64)) > 0).all()
    # no landmark observed: JAX's padded 8 landmarks get identity blocks in
    # both packages; a graph of no landmarks, an empty covariance
    ring = tsp.landmark_covariance_se2(graphs["ring"][1])
    np.testing.assert_array_equal(ring.numpy(), np.asarray(jsp.landmark_covariance_se2(graphs["ring"][0])))
    pose_only, _ = graph2d_from_log(simulate(SimulatorConfig(n_poses=30)).to_g2o_log(with_landmarks=False),
                                    device="cpu")
    assert tsp.landmark_covariance_se2(pose_only).shape == (0, 2, 0, 2)


def test_padded_jax_graph_solves_to_the_exact_size_result(graphs):
    """The padded chain-landmark graph (64 poses for 40, 8 landmarks for 6,
    64/128 edge slots) against the same graph at its exact size, in the
    port; and `graph2d_from_log`'s capacities."""
    (_, gp), (_, g) = graphs["chain_padded"], graphs["chain"]
    assert gp.poses.shape[0] == 64 and g.poses.shape[0] == 40
    for solve in (lambda x: tsp.optimize_se2_schur(x, iters=8, cg_iters=120),
                  lambda x: tpg.optimize_se2(x, iters=4, cg_iters=60, precond="chain"),
                  lambda x: tpg.optimize_se2_direct(x, iters=8)):
        (op, sp), (o, s) = solve(gp), solve(g)
        np.testing.assert_allclose(sp.chi2.numpy(), s.chi2.numpy(), rtol=2e-3)
        np.testing.assert_allclose(float(sp.chi2[-1]), float(s.chi2[-1]), rtol=1e-4)
        np.testing.assert_allclose(op.poses.numpy()[:40], o.poses.numpy(), atol=1e-4)
        np.testing.assert_allclose(op.landmarks.numpy()[:6], o.landmarks.numpy(), atol=1e-4)
    log = simulate(SimulatorConfig(n_poses=30, n_landmarks=5)).to_g2o_log()
    gc, _ = graph2d_from_log(log, pose_capacity=32, edge_capacity=64, device="cpu")
    ge, _ = graph2d_from_log(log, device="cpu")
    assert gc.poses.shape == (32, 3) and gc.pp_ij.shape == (64, 2) and gc.n_poses == ge.poses.shape[0] == 30
    (oc, sc), (oe, se) = tpg.optimize_se2(gc, iters=3), tpg.optimize_se2(ge, iters=3)
    np.testing.assert_allclose(sc.chi2.numpy(), se.chi2.numpy(), rtol=1e-4)
    np.testing.assert_allclose(oc.poses.numpy()[:30], oe.poses.numpy(), atol=1e-4)


@pytest.mark.parametrize("precond", ["jacobi", "chain"])
def test_optimize_se3_on_bench_world_matches_jax(precond):
    gt, it = tsim.simulate_se3(tsim.Simulator3DConfig(**BENCH_SE3), device="cpu")
    gj, ij = simulate_se3(Simulator3DConfig(**BENCH_SE3))
    n, e = it["n_poses"], it["n_edges"]
    assert (n, e, it["n_closures"]) == (ij["n_poses"], ij["n_edges"], ij["n_closures"]) == (300, 310, 11)
    for f in dataclasses.fields(gt):
        np.testing.assert_array_equal(getattr(gt, f.name).numpy(), np.asarray(getattr(gj, f.name))[: n if
                                      f.name in ("poses", "pose_mask", "fixed") else e], err_msg=f.name)
    _, sj = jpg.optimize_se3(gj, iters=10, cg_iters=100, precond=precond)
    _, st = tpg.optimize_se3(gt, iters=10, cg_iters=100, precond=precond)
    np.testing.assert_allclose(float(st.chi2[-1]), float(sj.chi2[-1]), rtol=1e-3)
    ctl = control_optimize_se3(gj, max_iters=60)["chi2"]
    ratio = float(st.chi2[-1]) / ctl
    print(f"optimize_se3 ({precond}, 10 LM iterations) / control_optimize_se3 = {ratio:.6f} (control {ctl:.4f})")
    if float(sj.chi2[-1]) <= 1.01 * ctl:
        assert ratio <= 1.01
