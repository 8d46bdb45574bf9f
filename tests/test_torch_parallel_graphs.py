"""PyTorch port: the distributed solvers' LM loops (`parallel/`) through
``utils/graphs.solve_loop``, as the JAX package runs each as one
``jax.jit`` over a ``fori_loop`` / ``while_loop``, on the CPU.

The cases are ``tools/graph_probe.py``'s `PARALLEL` (the six solvers, both
preconditioners of the partitioned SE2 and SE3 solvers, the partitioned
Schur solver with and without landmarks) on small simulated worlds,
every shard on a `StackedMesh` of 2 or 4 shards.

- In the CPU's "masked" mode (CG in blocks of 1, 5 and 64 masked steps,
  64 above every cap) and in "eager" mode, each solver is bit-equal to a
  verbatim copy of its loop before this form (``tests/pre_graph_solvers.py``):
  poses, landmarks, the chi2 trace and the CG and LM counts of the stats.
- With the CUDA graph replaced by a stand-in that reruns the captured
  function (``tests/test_torch_solver_graphs.StandIn``): the first call of
  a key runs its CG blocks through a dropped graph, the second captures
  the chain of three graphs, the third replays it; all bit-equal to the
  copy; a new `StackedMesh` of the same size replays the same chain;
  host reads one a CG block and one report a solve (the Schur solver one
  an LM iteration); the replayed solve counts the masked run's segment
  sums.
- No module of `parallel/` calls the eager `pcg`.

The JAX parity of these solvers is `tests/test_torch_parallel.py`'s; the
card's runs are ``tools/graph_probe.py --parallel`` and ``chip_smoke.py``
phase 15.
"""
import inspect

import pytest
import torch

from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.parallel import (mesh, partitioned_pose_graph, partitioned_schur, sharded_ba,
                                             sharded_pose_graph, sharded_pose_graph3d)
from g2o_frontend_tpu_torch.solvers import pcg
from g2o_frontend_tpu_torch.utils import graphs
from tests import pre_graph_solvers as pre
from tests.test_torch_solver_graphs import bits, stand_in  # noqa: F401  (a fixture)
from tools import graph_probe

torch.set_num_threads(1)

NAMES = list(graph_probe.PARALLEL)


@pytest.fixture(scope="module")
def worlds():
    return graph_probe.parallel_worlds(torch.device("cpu"))


_WANT = {}


def want(worlds, name, n_dev):
    """The pre-graph loop's result, once a (solver, mesh size)."""
    if (name, n_dev) not in _WANT:
        before = graph_probe.parallel_cases(torch.device("cpu"), n_dev, worlds, lambda fn: getattr(pre, fn))[name]
        _WANT[name, n_dev] = graph_probe.solver_leaves(before())
    return _WANT[name, n_dev]


def now(worlds, name, n_dev):
    return graph_probe.parallel_cases(torch.device("cpu"), n_dev, worlds)[name]


@pytest.mark.parametrize("block", [1, 5, 64])
@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_distributed_solver_equals_its_pre_graph_loop(monkeypatch, worlds, name, n_dev, block):
    monkeypatch.setattr(pcg, "BLOCK", block)
    solve = now(worlds, name, n_dev)
    assert bits(*zip(graph_probe.solver_leaves(solve()), want(worlds, name, n_dev)))  # the CPU's masked blocks
    if block == 1:
        with graphs.mode("eager"):
            assert bits(*zip(graph_probe.solver_leaves(solve()), want(worlds, name, n_dev)))


@pytest.mark.parametrize("name", NAMES)
def test_distributed_captured_paths_equal_the_pre_graph_loop(stand_in, worlds, name):
    solve, expect = now(worlds, name, 2), want(worlds, name, 2)
    first = graph_probe.solver_leaves(solve())  # a key seen once: head and tail eager, the CG blocks through _Blocks
    assert not any(kept for _, kept in stand_in["pieces"])
    second = graph_probe.solver_leaves(solve())  # the chain captured
    third = graph_probe.solver_leaves(now(worlds, name, 2)())  # a new StackedMesh(2): the same key, a replay
    assert len([n for n, k in stand_in["pieces"] if k]) == 3
    assert bits(*zip(first, expect)) and bits(*zip(second, expect)) and bits(*zip(third, expect))


@pytest.mark.parametrize("name", NAMES)
def test_distributed_host_reads_and_launches(stand_in, worlds, name, monkeypatch):
    """One host read of the CG flag a block and one report a solve, or one
    an LM iteration where the solve stops on convergence; the replayed
    solve counts the masked run's segment-sum launches."""
    caps = graph_probe.PARALLEL[name][3]
    solve = now(worlds, name, 2)
    real_bool, real_tolist = torch.Tensor.__bool__, torch.Tensor.tolist
    reads, counts, lm = [], [], None
    for mode in ("masked", "graph", "graph", "graph"):
        monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append("flag") or real_bool(t))
        monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append("report") or real_tolist(t))
        reads.clear()
        ss.launches = 0
        with graphs.mode(mode):
            out = solve()
        counts.append(ss.launches)
        monkeypatch.setattr(torch.Tensor, "__bool__", real_bool)
        monkeypatch.setattr(torch.Tensor, "tolist", real_tolist)
        lm = out[2]["lm_iters"] if len(out) == 3 and "lm_iters" in out[2] else None
        assert reads.count("report") == (1 if lm is None else lm)
        assert reads.count("flag") <= (lm or caps["iters"]) * -(-caps["cg_iters"] // pcg.BLOCK)
    assert counts[0] > 0 and counts == [counts[0]] * 4


def test_stacked_mesh_is_a_static_argument():
    a, b = mesh.StackedMesh(2, "cpu"), mesh.StackedMesh(2, "cpu")
    assert a == b and hash(a) == hash(b) and a != mesh.StackedMesh(4, "cpu")
    assert graphs.key(a)[0] == graphs.key(b)[0] != graphs.key(mesh.StackedMesh(4, "cpu"))[0]


def test_no_caller_of_the_eager_pcg_in_parallel():
    for mod in (sharded_pose_graph, sharded_pose_graph3d, sharded_ba, partitioned_pose_graph, partitioned_schur):
        src = inspect.getsource(mod)
        assert "pcg(" not in src.replace("cg_loop(", "").replace("cg_carry(", ""), mod.__name__
        assert "import pcg" not in src and " pcg," not in src, mod.__name__
