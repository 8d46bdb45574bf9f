"""PyTorch port: slice 6, the distributed solvers (`parallel/`), against
the JAX package on its 8-device virtual CPU mesh (tests/conftest.py).

The port runs every shard in one process on a `StackedMesh` on the CPU;
the JAX functions run under ``shard_map`` on the virtual mesh. Inputs come
from numpy seeds: random ghost directories (tests/test_halo.py) and block
tridiagonals (tests/test_spike.py), the simulators' SE2, SE3 and BA
worlds. Graphs go to JAX at the port's exact counts, so that both
packages partition and shard the same rows. Both run in float32.

Tolerances, each with a margin over what was observed:
- halo gather: equal; halo reduce within 1e-6 (scatter-add order);
- schedules and partitions: equal (the content of each shard);
- spike_solve: the dense float64 solve within rtol/atol 2e-4 (the JAX
  test's), JAX within 1e-5 (observed 2e-7);
- solvers, a few LM iterations: chi2 traces within rtol 1e-5 of JAX's
  (observed <= 1.1e-6; the Schur runs 1e-4, observed 1e-5), poses and
  landmarks within 1e-4 (observed 4e-6; Schur 5e-3, observed 3e-3 on a
  flat optimum), LM counts equal, CG counts equal where the cap binds.
  Where CG stops on its tolerance (rtol 1e-8 on sqrt(r.z): r.z falls
  below float32's resolution first) the count moves with rounding (an
  uncapped jacobi run: 387 against 355 at equal poses): within 25%
  (observed 14% and 17%), with every other entry of the stats equal.
"""
import ast
import dataclasses
import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import chip_smoke
from g2o_frontend_tpu.graph.store import PoseGraph2D as JPoseGraph2D
from g2o_frontend_tpu.graph.store import graph2d_from_log as jgraph2d_from_log
from g2o_frontend_tpu.parallel import halo as jhalo
from g2o_frontend_tpu.parallel import mesh as jmesh
from g2o_frontend_tpu.parallel import partitioned_pose_graph as jpp
from g2o_frontend_tpu.parallel import partitioned_schur as jps
from g2o_frontend_tpu.parallel import sharded_ba as jsba
from g2o_frontend_tpu.parallel import sharded_pose_graph as jsp
from g2o_frontend_tpu.parallel import sharded_pose_graph3d as jsp3
from g2o_frontend_tpu.parallel import spike as jspike
from g2o_frontend_tpu.slam.simulator import Simulator3DConfig, SimulatorConfig, simulate, simulate_se3
from g2o_frontend_tpu.solvers import ba as jba
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.parallel import halo, mesh, partitioned_pose_graph as tpp, partitioned_schur as tps
from g2o_frontend_tpu_torch.parallel import sharded_ba, sharded_pose_graph, sharded_pose_graph3d, spike
from g2o_frontend_tpu_torch.solvers import ba as tba
from g2o_frontend_tpu_torch.solvers import pcg as tpcg
from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
from g2o_frontend_tpu_torch.solvers import tridiag as ttri
from tests.test_halo import _random_ghosts
from tests.test_spike import _chain_system

torch.set_num_threads(1)

SE2_WORLD = SimulatorConfig(n_poses=120, n_landmarks=30)
SE3_WORLD = Simulator3DConfig(n_poses=60, seed=0, world_size=8.0, closure_min_gap=10, closure_radius=2.5,
                              closure_prob=0.9)
BA_WORLD = dict(n_poses=10, n_points=80, per_point=4, seed=3)


def _jax_fields(obj):
    """A port graph or problem's fields as JAX arrays: indices int32."""
    items = obj._asdict().items() if hasattr(obj, "_asdict") else (
        (f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return {k: jnp.asarray(v.numpy().astype(np.int32) if k.endswith("_ij") else v.numpy()) for k, v in items}


@pytest.fixture(scope="module")
def worlds():
    """name -> (port graph, JAX graph at the same counts)."""
    out = {}
    for name, wl in (("se2", True), ("se2_pose_only", False)):
        gt, _ = graph2d_from_log(simulate(SE2_WORLD).to_g2o_log(with_landmarks=wl), device="cpu")
        out[name] = (gt, JPoseGraph2D(**_jax_fields(gt)))
    gj, info = simulate_se3(SE3_WORLD)
    assert info["n_closures"] >= 3
    out["se3"] = (convert.pose_graph3d_from_numpy({f.name: np.asarray(getattr(gj, f.name))
                                                   for f in dataclasses.fields(gj)}, device="cpu"), gj)
    _, _, poses7, points, obs = chip_smoke.ba_world(**BA_WORLD)
    bt = tba.make_ba_problem(poses7, points, obs, device="cpu")
    out["ba"] = (bt, jba.BAProblem(**_jax_fields(bt)))
    return out


# -- the mesh --------------------------------------------------------------------


def test_stacked_mesh_collectives():
    """psum keeps a leading axis of 1; ppermute sends shard t to t+k;
    all_to_all hands lane [t, u] to u; make_mesh stacks without a process
    group; pad_to_multiple pads with the fill value as JAX does."""
    m = mesh.make_mesh(4, device="cpu")
    assert isinstance(m, mesh.StackedMesh) and m.size == 4 and mesh.make_mesh(device="cpu").size == 1
    x = torch.arange(4 * 3, dtype=torch.float32).view(4, 3)
    assert torch.equal(m.psum(x), x.sum(0, keepdim=True))
    assert torch.equal(m.ppermute(x, 1)[1], x[0]) and torch.equal(m.ppermute(x, -1)[0], x[1])
    lanes = torch.arange(4)[:, None] * 10 + torch.arange(4)[None]  # lane [t, u] = 10 t + u
    assert torch.equal(m.all_to_all(lanes), lanes.T)
    assert torch.equal(m.index(), torch.arange(4))
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    for fill in (0, -1.5):
        np.testing.assert_array_equal(mesh.pad_to_multiple(torch.as_tensor(a), 4, fill=fill).numpy(),
                                      np.asarray(jmesh.pad_to_multiple(a, 4, fill=fill)))
    t = torch.as_tensor(a)
    assert mesh.pad_to_multiple(t, 5) is t


# -- halo ------------------------------------------------------------------------


def _jax_halo(spec, v, own, gh):
    m = jmesh.make_mesh(spec.n_dev)
    ax = jmesh.EDGE_AXIS

    @partial(shard_map, mesh=m, in_specs=(P(ax),) * 5, out_specs=(P(ax), P(ax)))
    def run(v_blk, own, gh, sidx, rpos):
        g = jhalo.halo_gather(v_blk[0], sidx[0], rpos[0], spec, ax)
        r = jhalo.halo_reduce(own[0], gh[0], sidx[0], rpos[0], spec, ax)
        return g[None], r[None]

    g, r = jax.jit(run)(v, own, gh, jnp.asarray(spec.send_idx), jnp.asarray(spec.recv_pos))
    return np.asarray(g), np.asarray(r)


@pytest.mark.parametrize("n_dev,B,G,seed", [(2, 4, 3, 0), (4, 8, 5, 1), (8, 16, 7, 2)])
@pytest.mark.parametrize("mode", ["ppermute", "a2a"])
def test_halo_matches_jax(n_dev, B, G, seed, mode):
    ghosts = _random_ghosts(n_dev, B, G, seed)
    assert chip_smoke.random_ghosts(n_dev, B, G, seed) == ghosts  # phase 15's and the gloo test's copy
    spec = halo.build_halo_spec(ghosts, B, n_dev, G, mode=mode)
    jspec = jhalo.build_halo_spec(ghosts, B, n_dev, G, mode=mode)
    rng = np.random.default_rng(seed + 100)
    v = rng.normal(size=(n_dev, B, 3)).astype(np.float32)
    gh = np.zeros((n_dev, G, 3), np.float32)
    for s in range(n_dev):
        gh[s, : len(ghosts[s])] = rng.normal(size=(len(ghosts[s]), 3))
    own = rng.normal(size=(n_dev, B, 3)).astype(np.float32)
    m = mesh.StackedMesh(n_dev, "cpu")
    sidx, rpos = m.local(spec.send_idx, torch.int64), m.local(spec.recv_pos, torch.int64)
    g = halo.halo_gather(torch.as_tensor(v), sidx, rpos, spec, m).numpy()
    own_t = torch.as_tensor(own)
    r = halo.halo_reduce(own_t, torch.as_tensor(gh), sidx, rpos, spec, m).numpy()
    assert np.array_equal(own_t.numpy(), own)  # functional: the own blocks are not written
    g_j, r_j = _jax_halo(jspec, v, own, gh)
    np.testing.assert_array_equal(g, g_j)
    np.testing.assert_allclose(r, r_j, rtol=1e-6, atol=1e-6)
    # the oracle (tests/test_halo.py): owners' values, and ghost rows added
    r_ref, flat = own.copy(), v.reshape(-1, 3)
    for s in range(n_dev):
        for pos, gid in enumerate(ghosts[s]):
            np.testing.assert_array_equal(g[s, pos], flat[gid])
            r_ref[gid // B, gid % B] += gh[s, pos]
        assert np.all(g[s, len(ghosts[s]):] == 0.0)
    np.testing.assert_allclose(r, r_ref, rtol=1e-6, atol=1e-6)
    assert halo.halo_bytes_per_exchange(spec, 3) == jhalo.halo_bytes_per_exchange(jspec, 3)
    assert halo.halo_collectives_per_exchange(spec) == jhalo.halo_collectives_per_exchange(jspec)


def _body(fn, skip=0):
    """A function's AST with its first `skip` statements after the
    docstring left out."""
    tree = ast.parse(inspect.getsource(fn)).body[0]
    tree.body = tree.body[:1] + tree.body[1 + skip:]
    return ast.dump(tree)


def test_host_code_is_the_jax_code():
    """`build_halo_spec` is a copy, and `partition_se2` / `partition_se3`
    are copies after their first statement (the port's graph to numpy)."""
    assert _body(halo.build_halo_spec) == _body(jhalo.build_halo_spec)
    assert _body(tpp.partition_se2, 1) == _body(jpp.partition_se2)
    assert _body(tpp.partition_se3, 1) == _body(jpp.partition_se3)
    for name in ("partition_stats", "comm_volume"):
        assert _body(getattr(tpp, name)) == _body(getattr(jpp, name))


def _shard_content(part, s, B):
    """Shard s of a partition: its owned poses, the global endpoints of its
    edges, its ghost ids."""
    n_ghost = int((part.halo.recv_pos[s] < part.halo.n_ghost).sum())
    gids = part.ghost_ids[s]

    def glob(slot):
        return s * B + slot if slot < B else int(gids[slot - B])

    edges = sorted((glob(i), glob(j)) for (i, j), m in zip(part.pp_ij[s], part.pp_mask[s]) if m)
    return part.poses_blk[s], edges, gids[:n_ghost]


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_partition_matches_jax(worlds, n_dev):
    """The port's graph (exact counts) and JAX's own log-built graph (padded
    to powers of two): every shard's content, the halo schedules and the
    landmark ownership are equal."""
    gt, _ = worlds["se2"]
    gj, _ = jgraph2d_from_log(simulate(SE2_WORLD).to_g2o_log())
    pt, pj = tpp.partition_se2(gt, n_dev), jpp.partition_se2(gj, n_dev)
    B, NL = pt.poses_blk.shape[1], gt.landmarks.shape[0]
    assert B == pj.poses_blk.shape[1] and pt.n_poses == pj.n_poses
    for s in range(n_dev):
        for a, b in zip(_shard_content(pt, s, B), _shard_content(pj, s, B)):
            np.testing.assert_array_equal(a, b)
    for name in ("send_idx", "recv_pos"):
        np.testing.assert_array_equal(getattr(pt.halo, name), getattr(pj.halo, name))
        np.testing.assert_array_equal(getattr(pt.halo_l, name), getattr(pj.halo_l, name))
    assert pt.halo[:4] == pj.halo[:4] and pt.halo_l[:4] == pj.halo_l[:4]
    np.testing.assert_array_equal(pt.lm_owner, pj.lm_owner[:NL])
    np.testing.assert_array_equal(pt.lm_local, pj.lm_local[:NL])
    np.testing.assert_array_equal(pt.lms_blk[pt.lm_owner, pt.lm_local], np.asarray(gj.landmarks)[:NL])
    g3t, g3j = worlds["se3"]  # the same capacity in both packages
    p3t, p3j = tpp.partition_se3(g3t, n_dev), jpp.partition_se3(g3j, n_dev)
    for a, b in zip(p3t, p3j):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    assert p3t.halo[:4] == p3j.halo[:4]


# -- SPIKE -----------------------------------------------------------------------


def _spike_case(n_dev, d, m, seed, B=8):
    n = n_dev * B
    D, U, A = _chain_system(n, d, seed=seed)
    R = np.random.default_rng(seed + 1).normal(0, 1, (n, d, m))
    X_ref = np.linalg.solve(A, R.reshape(n * d, m)).reshape(n, d, m)
    U_loc, L_loc = np.zeros((n_dev, B, d, d)), np.zeros((n_dev, B, d, d))
    U_bnd = np.zeros((n_dev, d, d))
    for s in range(n_dev):
        lo = s * B
        for i in range(B - 1):
            U_loc[s, i], L_loc[s, i + 1] = U[lo + i], U[lo + i].T
        if s < n_dev - 1:
            U_bnd[s] = U[lo + B - 1]
    f32 = [a.astype(np.float32) for a in (L_loc, D.reshape(n_dev, B, d, d), U_loc, U_bnd, R.reshape(n_dev, B, d, m))]
    return f32, X_ref


def _jax_spike(n_dev, L, Dm, U, U_bnd, R):
    m = jmesh.make_mesh(n_dev)
    ax = jmesh.EDGE_AXIS

    @jax.jit
    @partial(shard_map, mesh=m, in_specs=(P(ax),) * 5, out_specs=P(ax))
    def solve(Lb, Db, Ub, Ubnd, Rb):
        sf = jspike.spike_factor(Lb[0], Db[0], Ub[0], Ubnd[0], ax, n_dev)
        return jspike.spike_solve(sf, Rb[0], ax)[None]

    with jax.default_matmul_precision("highest"):
        return np.asarray(solve(L, Dm, U, U_bnd, R))


@pytest.mark.parametrize("n_dev,d,m", [(1, 3, 1), (2, 3, 1), (4, 6, 1), (8, 3, 1), (8, 6, 1), (4, 3, 5)])
def test_spike_matches_jax_and_dense(n_dev, d, m):
    """One right-hand side (squeezed, as the preconditioners call it) and
    m = 5 at once; D = 1 degenerates to the local cyclic reduction."""
    (L, Dm, U, U_bnd, R), X_ref = _spike_case(n_dev, d, m, seed=10 * n_dev + d)
    msh = mesh.StackedMesh(n_dev, "cpu")
    sf = spike.spike_factor(*(torch.as_tensor(a) for a in (L, Dm, U, U_bnd)), msh)
    rhs = torch.as_tensor(R[..., 0] if m == 1 else R)
    X = spike.spike_solve(sf, rhs, msh).numpy().reshape(X_ref.shape)
    np.testing.assert_allclose(X, X_ref, rtol=2e-4, atol=2e-4)
    X_j = _jax_spike(n_dev, L, Dm, U, U_bnd, R[..., 0] if m == 1 else R).reshape(X_ref.shape)
    np.testing.assert_allclose(X, X_j, rtol=1e-5, atol=1e-5)
    if n_dev == 1:  # no boundary: the plain cyclic reduction
        ref = ttri.cr_solve(ttri.cr_factor(*(torch.as_tensor(a[0]) for a in (L, Dm, U))), rhs[0])
        np.testing.assert_allclose(X, ref.numpy().reshape(X_ref.shape), rtol=1e-6, atol=1e-6)
    assert spike.spike_solve_bytes(n_dev, d, m) == jspike.spike_solve_bytes(n_dev, d, m)


# -- the single-device pieces the solvers build on -------------------------------


def _seed_pcg(hvp, b, precond, max_iters, rtol):
    """The port's PCG loop before `tree_dot` existed, verbatim."""
    dot = lambda a, c: sum((x * y).sum() for x, y in zip(a, c))  # noqa: E731
    axpy = lambda al, x, y: tuple(al * xl + yl for xl, yl in zip(x, y))  # noqa: E731
    x, r = tuple(torch.zeros_like(bl) for bl in b), tuple(b)
    z = precond(r)
    p, rz = z, dot(r, z)
    tol2 = rtol * rtol * torch.clamp_min(rz, 1e-30)
    k = 0
    while k < max_iters and bool(rz > tol2):
        hp = hvp(p)
        php = dot(p, hp)
        alpha = torch.where(php > 0, rz / torch.where(php > 0, php, 1e-30), 0.0)
        x, r = axpy(alpha, p, x), axpy(-alpha, hp, r)
        z = precond(r)
        rz_new = dot(r, z)
        p, rz = axpy(rz_new / torch.where(rz > 0, rz, 1e-30), p, z), rz_new
        k += 1
    return x, k, rz


def test_pcg_default_dot_is_unchanged(worlds):
    """`pcg` without `tree_dot` is the loop it was, bit for bit, on one LM
    system of the SE2 world; a mesh's psum dot over one stacked shard gives
    the same solve."""
    gt, _ = worlds["se2"]
    lin = tpg.linearize_se2(gt)
    free_p = (gt.pose_mask & ~gt.fixed).float()
    free_l = gt.landmark_mask.float()
    Dp, Dl = tpg._diag_blocks_se2(gt, lin)
    gp, gl = tpg._grad_se2(gt, lin)
    hvp = tpg._compose_hvp(tpg._hvp_edges_se2(gt, lin), free_p, free_l, 1e-4, Dp, Dl)
    pre = tpg._block_jacobi_precond(Dp, Dl, free_p, free_l, 1e-4)
    b = (-gp * free_p[:, None], -gl * free_l[:, None])
    x, k, rz = tpcg.pcg(hvp, b, pre, max_iters=60, rtol=1e-8)
    x0, k0, rz0 = _seed_pcg(hvp, b, pre, 60, 1e-8)
    assert k == k0 and torch.equal(rz, rz0) and all(torch.equal(a, c) for a, c in zip(x, x0))
    m = mesh.StackedMesh(1, "cpu")

    def psum_dot(a, c):
        return m.psum(sum((u * v).sum() for u, v in zip(a, c))[None])[0]

    x1, k1, _ = tpcg.pcg(hvp, b, pre, max_iters=60, rtol=1e-8, tree_dot=psum_dot)
    assert k1 == k and all(torch.equal(a, c) for a, c in zip(x1, x))


def test_cyclic_reduction_batched_over_shards():
    """cr_factor / cr_solve with a leading shard axis solve each system as
    the unbatched call does (within 1e-6)."""
    systems = [_chain_system(13, 3, seed=s) for s in range(3)]
    L, Dm, U, R = [], [], [], []
    for s, (D, Ub, _) in enumerate(systems):
        Uz = np.concatenate([Ub[:-1], np.zeros((1, 3, 3))])
        L.append(np.concatenate([np.zeros((1, 3, 3)), np.swapaxes(Ub[:-1], 1, 2)]))
        Dm.append(D)
        U.append(Uz)
        R.append(np.random.default_rng(s).normal(size=(13, 3)))
    L, Dm, U, R = (torch.as_tensor(np.stack(a), dtype=torch.float32) for a in (L, Dm, U, R))
    fac = ttri.cr_factor(L, Dm, U)
    X = ttri.cr_solve(fac, R)
    for s in range(3):
        x = ttri.cr_solve(ttri.cr_factor(L[s], Dm[s], U[s]), R[s])
        np.testing.assert_allclose(X[s].numpy(), x.numpy(), rtol=1e-6, atol=1e-6)
    assert ttri.cr_solve(fac, R[..., None].expand(3, 13, 3, 2)).shape == (3, 13, 3, 2)


# -- the solvers -----------------------------------------------------------------


def _close(port_trace, jax_trace, rtol):
    np.testing.assert_allclose(port_trace.numpy(), np.asarray(jax_trace), rtol=rtol)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_se2_matches_jax(worlds, n_dev):
    gt, gj = worlds["se2"]
    g1, tr = sharded_pose_graph.optimize_se2_sharded(gt, mesh.StackedMesh(n_dev, "cpu"), iters=4, cg_iters=50)
    gj1, trj = jsp.optimize_se2_sharded(gj, jmesh.make_mesh(n_dev), iters=4, cg_iters=50)
    _close(tr, trj, 1e-5)
    np.testing.assert_allclose(g1.poses.numpy(), np.asarray(gj1.poses), atol=1e-4)
    np.testing.assert_allclose(g1.landmarks.numpy(), np.asarray(gj1.landmarks), atol=1e-4)


def test_sharded_se3_matches_jax(worlds):
    gt, gj = worlds["se3"]
    g1, tr = sharded_pose_graph3d.optimize_se3_sharded(gt, mesh.StackedMesh(8, "cpu"), iters=4, cg_iters=50)
    with jax.default_matmul_precision("highest"):
        gj1, trj = jsp3.optimize_se3_sharded(gj, jmesh.make_mesh(8), iters=4, cg_iters=50)
    _close(tr, trj, 1e-5)
    np.testing.assert_allclose(g1.poses.numpy(), np.asarray(gj1.poses), atol=1e-4)


def test_sharded_ba_matches_jax(worlds):
    bt, bj = worlds["ba"]
    b1, tr = sharded_ba.optimize_ba_sharded(bt, mesh.StackedMesh(4, "cpu"), iters=5, cg_iters=30)
    with jax.default_matmul_precision("highest"):
        bj1, trj = jsba.optimize_ba_sharded(bj, jmesh.make_mesh(4), iters=5, cg_iters=30)
    _close(tr, trj, 1e-5)
    np.testing.assert_allclose(b1.poses.numpy(), np.asarray(bj1.poses), atol=1e-4)
    np.testing.assert_allclose(b1.points.numpy(), np.asarray(bj1.points), atol=1e-4)


def _same_stats(st, stj, cg_share):
    """Equal partition and communication accounting; CG counts within
    `cg_share` (0: equal), and the comm entries that count them alike."""
    assert abs(st["cg_total"] - stj["cg_total"]) <= cg_share * stj["cg_total"], (st["cg_total"], stj["cg_total"])
    drop = {"bytes_total", "cg_matvecs"}
    assert {k: v for k, v in st["comm"].items() if k not in drop} == {
        k: v for k, v in stj["comm"].items() if k not in drop}
    for key in set(stj) - {"cg_total", "comm"}:
        assert st[key] == stj[key], key


@pytest.mark.parametrize("precond,iters,cg_iters", [("jacobi", 4, 50), ("chain", 3, 200)])
def test_partitioned_se2_matches_jax(worlds, precond, iters, cg_iters):
    """The chain runs CG to its tolerance: capped at 50 iterations (81
    needed), the truncated solves of the two packages part by 7.7e-4 in the
    poses; run to convergence they agree within 2e-6."""
    gt, gj = worlds["se2"]
    kw = dict(iters=iters, cg_iters=cg_iters, precond=precond)
    g1, tr, st = tpp.optimize_se2_partitioned(gt, mesh.StackedMesh(8, "cpu"), **kw)
    gj1, trj, stj = jpp.optimize_se2_partitioned(gj, jmesh.make_mesh(8), **kw)
    _close(tr, trj, 1e-5)
    np.testing.assert_allclose(g1.poses.numpy(), np.asarray(gj1.poses), atol=1e-4)
    np.testing.assert_allclose(g1.landmarks.numpy(), np.asarray(gj1.landmarks), atol=1e-4)
    _same_stats(st, stj, 0.0 if precond == "jacobi" else 0.25)


@pytest.mark.parametrize("precond", ["jacobi", "spike"])
def test_partitioned_se3_matches_jax(worlds, precond):
    gt, gj = worlds["se3"]
    g1, tr = tpp.optimize_se3_partitioned(gt, mesh.StackedMesh(4, "cpu"), iters=4, cg_iters=50, precond=precond)
    with jax.default_matmul_precision("highest"):
        gj1, trj = jpp.optimize_se3_partitioned(gj, jmesh.make_mesh(4), iters=4, cg_iters=50, precond=precond)
    _close(tr, trj, 1e-5)
    np.testing.assert_allclose(g1.poses.numpy(), np.asarray(gj1.poses), atol=1e-4)


@pytest.mark.parametrize("world", ["se2", "se2_pose_only"])
def test_partitioned_schur_matches_jax(worlds, world):
    gt, gj = worlds[world]
    kw = dict(iters=12, cg_iters=50, lm_lambda0=1e-3)
    g1, tr, st = tps.optimize_se2_schur_partitioned(gt, mesh.StackedMesh(8, "cpu"), **kw)
    gj1, trj, stj = jps.optimize_se2_schur_partitioned(gj, jmesh.make_mesh(8), **kw)
    _close(tr, trj, 1e-4)
    np.testing.assert_allclose(g1.poses.numpy(), np.asarray(gj1.poses), atol=5e-3)
    np.testing.assert_allclose(g1.landmarks.numpy(), np.asarray(gj1.landmarks), atol=5e-3)
    _same_stats(st, stj, 0.25)


def test_partitioned_solvers_refuse_unknown_options(worlds):
    gt, _ = worlds["se2"]
    with pytest.raises(ValueError, match="precond"):
        tpp.optimize_se2_partitioned(gt, mesh.StackedMesh(2, "cpu"), precond="spike")
    with pytest.raises(ValueError, match="precond"):
        tpp.optimize_se3_partitioned(worlds["se3"][0], mesh.StackedMesh(2, "cpu"), precond="chain")
