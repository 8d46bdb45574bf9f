"""PyTorch port: the SE2 Lie maps, the SE2 linearization and the LM/PCG
and dense SE2 solvers, against the JAX package.

Graphs: tests/test_pose_graph.py's noisy circle (`make_circle_graph`, no
landmarks), tests/test_schur_pcg.py's chain with landmarks
(`_chain_landmark_graph`, padded and unpadded, carried across with
`convert.pose_graph2d_from_numpy`) and the default `simulate()` world (200
poses, 80 landmarks). Graphs read from a log are packed at their exact
counts in the port and padded to powers of two in JAX: only the unpadded
prefix is compared. Both packages run on the CPU in float32.

Tolerances (those of tests/test_torch_pose_graph.py):
- SE2 Lie maps on random batches with angles across +-pi: atol 1e-5;
- `linearize_se2`, with and without Huber: chi2 within rtol 1e-5,
  residuals within atol 1e-4, Jacobians within atol 2e-4;
- `optimize_se2` (jacobi, chain): the chi2 trace within rtol 1e-3 and the
  poses and landmarks within atol 1e-4 after 4 LM iterations; a solver that
  reaches 1.01x `control_optimize_se2` in JAX does so in the port. Four
  iterations stop short of the float32 floor: past it LM accepts steps that
  lower chi2 by one ulp, and the two packages' poses wander apart along the
  flat optimum (the chain-landmark graph with the chain preconditioner: 1.1e-5
  after 4 iterations, 3.3e-3 after 6, chi2 4.382593 in both);
- `optimize_se2_direct`: poses and landmarks within atol 1e-4 and the final
  chi2 within rtol 1e-4, the trace within rtol 5e-3, wider than 1e-3 for
  its first step on the chain-landmark graph: a float32 Cholesky step of a
  system of condition ~9e5 at lambda 1e-6, where JAX's step gives chi2
  258.98, the port's 259.86 and the port's in float64 259.21 (both within
  0.3% of it, 0.34% apart);
- the Huber outlier case of tests/test_pose_graph.py: the trace within
  rtol 1e-3 and the poses within atol 1e-4 after 4 iterations, and after
  its 15 the port's robust solve within 0.35x the quadratic one's error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.graph.store import graph2d_from_log as jgraph2d_from_log
from g2o_frontend_tpu.io.g2o import G2OLog
from g2o_frontend_tpu.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu.solvers import pose_graph as jpg
from g2o_frontend_tpu.solvers.control import control_optimize_se2
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
from g2o_frontend_tpu_torch.utils import lie as tlie
from tests.test_pose_graph import make_circle_graph
from tests.test_schur_pcg import _chain_landmark_graph

torch.set_num_threads(1)


def jax_graph_to_port(g):
    return convert.pose_graph2d_from_numpy({f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)},
                                           device="cpu")


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX graph, port graph): log-built pairs differ in padding."""
    out = {}
    circle, _ = make_circle_graph()
    world = simulate(SimulatorConfig()).to_g2o_log()
    for name, log in (("circle", circle), ("world", world)):
        out[name] = (jgraph2d_from_log(log)[0], graph2d_from_log(log, device="cpu")[0])
    for name, pad in (("chain", False), ("chain_padded", True)):
        gj = _chain_landmark_graph(pad=pad)
        out[name] = (gj, jax_graph_to_port(gj))
    assert out["circle"][1].landmarks.shape == (0, 2) and out["circle"][0].landmarks.shape[0] == 8
    assert out["world"][1].poses.shape == (200, 3) and out["world"][0].poses.shape == (256, 3)
    return out


def _prefix(a, like):
    return np.asarray(a)[: like.shape[0]]


def test_se2_lie_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform([-5, -5, -3.14], [5, 5, 3.14], (256, 3)).astype(np.float32)
    b = rng.uniform([-5, -5, -3.14], [5, 5, 3.14], (256, 3)).astype(np.float32)
    p = rng.normal(size=(256, 2)).astype(np.float32)
    ta, tb, tp = (torch.from_numpy(x) for x in (a, b, p))
    ja, jb, jp = (jnp.asarray(x) for x in (a, b, p))
    for name, targs, jargs in (("se2_v2t", (ta,), (ja,)), ("se2_compose", (ta, tb), (ja, jb)),
                               ("se2_inverse", (ta,), (ja,)), ("se2_relative", (ta, tb), (ja, jb)),
                               ("se2_apply", (ta, tp), (ja, jp))):
        np.testing.assert_allclose(getattr(tlie, name)(*targs).numpy(),
                                   np.asarray(jax.vmap(getattr(jlie, name))(*jargs)), atol=1e-5, err_msg=name)
    T = tlie.se2_v2t(ta)
    np.testing.assert_allclose(tlie.se2_t2v(T).numpy(), np.asarray(jax.vmap(jlie.se2_t2v)(jnp.asarray(T.numpy()))),
                               atol=1e-5)
    th = rng.uniform(-12, 12, 512).astype(np.float32)
    np.testing.assert_allclose(tlie.wrap_angle(torch.from_numpy(th)).numpy(), np.asarray(jlie.wrap_angle(th)),
                               atol=1e-5)
    # a single point through a batch of poses, and one pose over many points
    np.testing.assert_allclose(tlie.se2_apply(ta[0], tp).numpy(), np.asarray(jlie.se2_apply(ja[0], jp)), atol=1e-5)


@pytest.mark.parametrize("huber", [None, 1.0])
@pytest.mark.parametrize("name", ["circle", "chain", "chain_padded", "world"])
def test_linearize_se2_matches_jax(graphs, name, huber):
    gj, gt = graphs[name]
    lj = jax.jit(jpg.linearize_se2, static_argnames="huber_delta")(gj, huber_delta=huber)
    lt = tpg.linearize_se2(gt, huber)
    np.testing.assert_allclose(float(lt.chi2), float(lj.chi2), rtol=1e-5)
    for f in ("e_pp", "Ji_pp", "Jj_pp", "e_pl", "Jp_pl", "Jl_pl"):
        t = getattr(lt, f)
        if t is None:
            assert f.endswith("_pl") and gt.pl_ij.shape[0] == 0
            continue
        np.testing.assert_allclose(t.numpy(), _prefix(getattr(lj, f), t), atol=1e-4 if f.startswith("e") else 2e-4,
                                   err_msg=f)
    np.testing.assert_allclose(lt.w_pp.numpy(), _prefix(lj.w_pp, lt.w_pp), rtol=1e-5)
    if huber is None:
        np.testing.assert_allclose(float(tpg.chi2_se2(gt)), float(lt.chi2))


def _check_solve(gj, gt, sj, st, gj_opt, gt_opt, rtol=1e-3):
    np.testing.assert_allclose(st.chi2.numpy(), np.asarray(sj.chi2), rtol=rtol)
    np.testing.assert_allclose(gt_opt.poses.numpy(), _prefix(gj_opt.poses, gt_opt.poses), atol=1e-4)
    np.testing.assert_allclose(gt_opt.landmarks.numpy(), _prefix(gj_opt.landmarks, gt_opt.landmarks), atol=1e-4)
    ctl = control_optimize_se2(gj)["chi2"]
    if float(sj.chi2[-1]) <= 1.01 * ctl:
        assert float(st.chi2[-1]) <= 1.01 * ctl


@pytest.mark.parametrize("precond", ["jacobi", "chain"])
@pytest.mark.parametrize("name", ["circle", "chain", "world"])
def test_optimize_se2_matches_jax(graphs, name, precond):
    gj, gt = graphs[name]
    gj_opt, sj = jpg.optimize_se2(gj, iters=4, cg_iters=60, precond=precond)
    gt_opt, st = tpg.optimize_se2(gt, iters=4, cg_iters=60, precond=precond)
    _check_solve(gj, gt, sj, st, gj_opt, gt_opt)
    assert float(st.chi2[-1]) < 0.5 * float(st.chi2[0]) and st.cg_iters > 0
    with pytest.raises(ValueError):
        tpg.optimize_se2(gt, iters=1, precond="ilu")


@pytest.mark.parametrize("name", ["chain", "world"])
def test_optimize_se2_direct_matches_jax(graphs, name):
    gj, gt = graphs[name]
    gj_opt, sj = jpg.optimize_se2_direct(gj, iters=20)
    gt_opt, st = tpg.optimize_se2_direct(gt, iters=20)
    _check_solve(gj, gt, sj, st, gj_opt, gt_opt, rtol=5e-3)
    np.testing.assert_allclose(float(st.chi2[-1]), float(sj.chi2[-1]), rtol=1e-4)
    assert float(st.chi2[-1]) <= 1.01 * control_optimize_se2(gj)["chi2"]
    assert 0 < st.cg_iters <= 20


def test_huber_downweights_outlier_edge_like_jax():
    """tests/test_pose_graph.py::test_huber_downweights_outlier_edge through
    both packages."""
    n = 30
    gt = np.zeros((n, 3))
    gt[:, 0] = np.arange(n, dtype=float)
    pp_ij = [[i, i + 1] for i in range(n - 1)] + [[5, 25]]
    pp_z = [[1.0, 0.0, 0.0]] * (n - 1) + [[0.0, 0.0, 0.0]]
    init = gt + np.random.default_rng(1234).normal(0, 0.05, gt.shape)
    init[0] = gt[0]
    log = G2OLog(se2_ids=np.arange(n), se2_poses=init, edge_se2_ij=np.asarray(pp_ij),
                 edge_se2_meas=np.asarray(pp_z, float), edge_se2_info=np.tile(np.eye(3) * 100, (n, 1, 1)),
                 fixed_ids=np.array([0]))
    gj, gt_ = jgraph2d_from_log(log)[0], graph2d_from_log(log, device="cpu")[0]
    errs = []
    for huber in (None, 3.0):
        pj, sj = jpg.optimize_se2(gj, iters=4, cg_iters=80, huber_delta=huber)
        pt, st = tpg.optimize_se2(gt_, iters=4, cg_iters=80, huber_delta=huber)
        np.testing.assert_allclose(st.chi2.numpy(), np.asarray(sj.chi2), rtol=1e-3)
        np.testing.assert_allclose(pt.poses.numpy(), np.asarray(pj.poses)[:n], atol=1e-4)
        pt, _ = tpg.optimize_se2(gt_, iters=15, cg_iters=80, huber_delta=huber)
        errs.append(np.abs(pt.poses.numpy()[:, :2] - gt[:, :2]).max())
    assert errs[0] > 1.0 and errs[1] < 0.35 * errs[0]
