"""PyTorch port: the SE3 pose-graph backend against the JAX package.

The graphs come from the JAX package's SE3 world simulator (40 poses, a few
closures), carried to the port with `convert.pose_graph3d_from_numpy`; the
block systems are made from a seeded numpy generator. Both packages run on
the CPU in float32.

Tolerances:
- `pcg` on a random SPD block-tridiagonal system against JAX's `pcg`:
  solutions within rtol 1e-4 of their norm, the same iteration count;
- `cr_solve` / `tridiag_solve` against JAX's and against a float64 dense
  solve: within rtol 1e-4 of the solution's norm, one and several
  right-hand sides, a block count that is not a power of two;
- `linearize_se3`: chi2 within rtol 1e-5, Jacobians within atol 2e-4;
- `optimize_se3` ("jacobi" and "chain"): the chi2 trace within rtol 1e-3,
  poses within atol 1e-4;
- `MapReflector.optimize` and `optimize_hierarchical` on two copies of one
  map (each package's MapManager and MapMerger): chi2 within rtol 1e-3,
  node poses within atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.graph import map_manager as jmm
from g2o_frontend_tpu.graph.reflector import MapReflector as JReflector
from g2o_frontend_tpu.slam.map_merger import MapMerger as JMerger
from g2o_frontend_tpu.slam.simulator import Simulator3DConfig, simulate_se3
from g2o_frontend_tpu.solvers import pcg as jpcg
from g2o_frontend_tpu.solvers import pose_graph as jpg
from g2o_frontend_tpu.solvers import tridiag as jtri
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.graph import map_manager as tmm
from g2o_frontend_tpu_torch.graph.reflector import MapReflector as TReflector
from g2o_frontend_tpu_torch.graph.store import PoseGraph3D, _cap
from g2o_frontend_tpu_torch.slam.map_merger import MapMerger as TMerger
from g2o_frontend_tpu_torch.solvers import pcg as tpcg
from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
from g2o_frontend_tpu_torch.solvers import tridiag as ttri

torch.set_num_threads(1)

SIM = Simulator3DConfig(n_poses=40, seed=0, world_size=8.0, closure_min_gap=10, closure_radius=2.5, closure_prob=0.9)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def sim_graph():
    g, info = simulate_se3(SIM)
    assert info["n_closures"] >= 2
    arrays = {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)}
    return g, convert.pose_graph3d_from_numpy(arrays)


def _block_tridiag(n, d, seed):
    """Random SPD block-tridiagonal system: (L, D, U) blocks and the dense matrix."""
    rng = np.random.default_rng(seed)
    U = rng.normal(0, 0.3, (n, d, d)).astype(np.float32)
    U[-1] = 0
    L = np.concatenate([np.zeros((1, d, d), np.float32), np.swapaxes(U, 1, 2)[:-1]])
    A = rng.normal(size=(n, d, d)).astype(np.float32)
    D = (A @ np.swapaxes(A, 1, 2) + 4 * d * np.eye(d, dtype=np.float32)).astype(np.float32)
    dense = np.zeros((n * d, n * d))
    for i in range(n):
        dense[i * d:(i + 1) * d, i * d:(i + 1) * d] = D[i]
        if i + 1 < n:
            dense[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d] = U[i]
            dense[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = L[i + 1]
    return L, D, U, dense


def test_pcg_matches_jax():
    n, d = 12, 6
    L, D, U, dense = _block_tridiag(n, d, seed=1)
    b = np.random.default_rng(2).normal(size=(n, d)).astype(np.float32)
    A32 = dense.astype(np.float32)
    Dinv = np.linalg.inv(D)
    xj, kj, _ = jpcg.pcg(lambda v: (jnp.asarray(A32) @ v[0].reshape(-1)).reshape(n, d)[None],
                         jnp.asarray(b)[None], lambda r: jnp.einsum("kij,kj->ki", jnp.asarray(Dinv), r[0])[None],
                         max_iters=60, rtol=1e-6)
    At, Dt = torch.from_numpy(A32), torch.from_numpy(Dinv)
    (xt,), kt, _ = tpcg.pcg(lambda v: ((At @ v[0].reshape(-1)).reshape(n, d),), (torch.from_numpy(b),),
                            lambda r: (torch.einsum("kij,kj->ki", Dt, r[0]),), max_iters=60, rtol=1e-6)
    assert kt == int(kj) > 3
    assert _rel(xt, np.asarray(xj)[0]) < 1e-4
    assert _rel(xt.numpy().reshape(-1), np.linalg.solve(dense, b.reshape(-1).astype(np.float64))) < 1e-4
    # max_iters bounds the trip count
    _, k2, _ = tpcg.pcg(lambda v: ((At @ v[0].reshape(-1)).reshape(n, d),), (torch.from_numpy(b),),
                        lambda r: r, max_iters=3, rtol=1e-12)
    assert k2 == 3


@pytest.mark.parametrize("n, m", [(13, None), (16, 3)], ids=["padded_one_rhs", "pow2_three_rhs"])
def test_cr_solve_matches_jax(n, m):
    d = 6
    L, D, U, dense = _block_tridiag(n, d, seed=n)
    rng = np.random.default_rng(5)
    r = rng.normal(size=(n, d) if m is None else (n, d, m)).astype(np.float32)
    xt = ttri.cr_solve(ttri.cr_factor(*(torch.from_numpy(x) for x in (L, D, U))), torch.from_numpy(r))
    xj = jtri.cr_solve(jtri.cr_factor(jnp.asarray(L), jnp.asarray(D), jnp.asarray(U)), jnp.asarray(r))
    assert tuple(xt.shape) == r.shape
    assert _rel(xt, np.asarray(xj)) < 1e-4
    exact = np.linalg.solve(dense, r.reshape(n * d, -1).astype(np.float64)).reshape(r.shape)
    assert _rel(xt, exact) < 1e-4
    one_shot = ttri.tridiag_solve(*(torch.from_numpy(x) for x in (L, D, U)), torch.from_numpy(r))
    np.testing.assert_array_equal(one_shot.numpy(), xt.numpy())


def test_linearize_se3_matches_jax(sim_graph):
    g, tg = sim_graph
    lj, lt = jax.jit(jpg.linearize_se3)(g), tpg.linearize_se3(tg)
    np.testing.assert_allclose(float(lt.chi2), float(lj.chi2), rtol=1e-5)
    np.testing.assert_allclose(lt.Ji_pp.numpy(), np.asarray(lj.Ji_pp), atol=2e-4)
    np.testing.assert_allclose(lt.Jj_pp.numpy(), np.asarray(lj.Jj_pp), atol=2e-4)
    np.testing.assert_allclose(float(tpg.chi2_se3(tg)), float(lt.chi2))
    assert lt.Ji_pp.dtype == torch.float32


@pytest.mark.parametrize("precond", ["jacobi", "chain"])
def test_optimize_se3_matches_jax(sim_graph, precond):
    g, tg = sim_graph
    gj, sj = jpg.optimize_se3(g, iters=6, cg_iters=50, precond=precond)
    gt, st = tpg.optimize_se3(tg, iters=6, cg_iters=50, precond=precond)
    np.testing.assert_allclose(st.chi2.numpy(), np.asarray(sj.chi2), rtol=1e-3)
    assert float(st.chi2[-1]) < 0.05 * float(st.chi2[0])
    np.testing.assert_allclose(gt.poses.numpy(), np.asarray(gj.poses), atol=1e-4)
    assert st.cg_iters > 0
    back = convert.pose_graph3d_to_numpy(gt)
    assert back["pp_ij"].dtype == np.int64 and back["pose_mask"].dtype == bool
    with pytest.raises(ValueError):
        tpg.optimize_se3(tg, iters=1, precond="ilu")


def _pose7_to_T(p):
    x, y, z, qx, qy, qz, qw = np.asarray(p, np.float64)
    n = np.linalg.norm([qx, qy, qz, qw])
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    T = np.eye(4)
    T[:3, :3] = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ]
    T[:3, 3] = (x, y, z)
    return T


def _map_of(mm, merger_cls, g):
    """A MapManager of module `mm` holding the simulated graph: odometry
    relations, the closures accepted, and a MapMerger's level-1 layer."""
    mgr = mm.MapManager()
    n, e = int(np.asarray(g.pose_mask).sum()), int(np.asarray(g.pp_mask).sum())
    nodes = [mgr.add_node(_pose7_to_T(p)) for p in np.asarray(g.poses)[:n]]
    merger = merger_cls(mgr, list_size=5)
    for node in nodes:
        merger.process_key_node(node)
    for (i, j), z, info in zip(np.asarray(g.pp_ij)[:e], np.asarray(g.pp_meas)[:e], np.asarray(g.pp_info)[:e]):
        closure = j != i + 1
        mgr.add_relation(mm.MapRelation(nodes[i], nodes[j], _pose7_to_T(z), np.asarray(info, np.float64),
                                        is_closure=closure, accepted=closure))
    return mgr


@pytest.mark.parametrize("mode", ["optimize", "hierarchical"])
def test_reflector_matches_jax(sim_graph, mode):
    g, _ = sim_graph
    mj, mt = _map_of(jmm, JMerger, g), _map_of(tmm, TMerger, g)
    assert len([n for n in mt.nodes if n.level == 1]) >= 3
    rj, rt = JReflector(mj), TReflector(mt, device="cpu")
    if mode == "optimize":
        cj, ct = rj.optimize(iters=6, cg_iters=40), rt.optimize(iters=6, cg_iters=40)
    else:
        (cj, _), (ct, cg) = rj.optimize_hierarchical(iters=4, cg_iters=40), rt.optimize_hierarchical(iters=4,
                                                                                                      cg_iters=40)
        assert cg["coarse_cg"] > 0 and cg["fine_cg"] > 0
    np.testing.assert_allclose(ct, cj, rtol=1e-3)
    for a, b in zip(mt.nodes, mj.nodes):
        np.testing.assert_allclose(a.transform, b.transform, atol=1e-4)
    graph = rt.build_graph()
    assert isinstance(graph, PoseGraph3D) and graph.n_poses == 40
    assert graph.poses.shape[0] == _cap(40) == 64
