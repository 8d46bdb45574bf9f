"""PyTorch port: the distributed solvers on a `ProcessMesh`, one gloo rank
a shard on the CPU, against the same calls on a `StackedMesh` of as many
shards in this process.

Each rank runs `halo_gather` / `halo_reduce` in both wire modes,
`spike_solve` and `optimize_se2_partitioned` (chain) on inputs made from
numpy seeds (`chip_smoke.random_ghosts`, `chip_smoke.chain_shards`, a
simulated world), and rank 0 writes what the mesh gathered to a file. The
ranks are spawned with a file store in the test's temporary directory
(no port, so parallel test workers cannot collide), and a deadline:
a rank that hangs in a collective fails the test instead of the suite.

Tolerance: every result within 1e-6 (rtol and atol) of the stacked run;
observed equal for the exchanges and SPIKE, and for the solve the same CG
count, poses within 3.4e-6 (all-reduce and batched cyclic reduction sum
in another order) and the chi2 trace within a relative 2e-8.
"""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import chip_smoke
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.parallel import halo, mesh, partitioned_pose_graph as tpp, spike
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate

DEADLINE_S = 240
WORLD = SimulatorConfig(n_poses=80, n_landmarks=16)


def _run(m, graph):
    """Every distributed call of the test on mesh `m`, its results gathered
    into full (D, ...) tensors."""
    out = {}
    n_dev, B, G = m.size, 8, 5
    ghosts = chip_smoke.random_ghosts(n_dev, B, G, seed=n_dev)
    rng = np.random.default_rng(n_dev + 100)
    v, own = rng.normal(size=(n_dev, B, 3)), rng.normal(size=(n_dev, B, 3))
    gh = rng.normal(size=(n_dev, G, 3))
    for mode in ("ppermute", "a2a"):
        spec = halo.build_halo_spec(ghosts, B, n_dev, G, mode=mode)
        sidx, rpos = m.local(spec.send_idx, torch.int64), m.local(spec.recv_pos, torch.int64)
        out[f"gather_{mode}"] = m.gather(halo.halo_gather(m.local(v, torch.float32), sidx, rpos, spec, m))
        out[f"reduce_{mode}"] = m.gather(halo.halo_reduce(m.local(own, torch.float32), m.local(gh, torch.float32), sidx,
                                                          rpos, spec, m))
    (L, D, U, U_bnd, R), _ = chip_smoke.chain_shards(n_dev)
    L, D, U, U_bnd, r = (m.local(a) for a in (L, D, U, U_bnd, R[..., 0]))
    out["spike"] = m.gather(spike.spike_solve(spike.spike_factor(L, D, U, U_bnd, m), r, m))
    g, trace, stats = tpp.optimize_se2_partitioned(graph, m, iters=3, cg_iters=40, precond="chain")
    out.update(poses=g.poses, landmarks=g.landmarks, trace=trace, cg=torch.tensor(stats["cg_total"]))
    return out


def _graph():
    return graph2d_from_log(simulate(WORLD).to_g2o_log(), device="cpu")[0]


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
    try:
        m = mesh.make_mesh(world, device="cpu")
        assert isinstance(m, mesh.ProcessMesh) and m.shards == 1 and m.size == world
        try:
            mesh.make_mesh(world + 1, device="cpu")
            raise AssertionError("make_mesh took a size other than the process group's")
        except ValueError:
            pass
        out = _run(m, _graph())
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_process_mesh_equals_stacked(world, tmp_path):
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_path)), nprocs=world, join=False)
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} gloo ranks did not finish within {DEADLINE_S} s")
    got = torch.load(tmp_path / "out.pt")
    want = _run(mesh.StackedMesh(world, "cpu"), _graph())
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6, err_msg=key)
