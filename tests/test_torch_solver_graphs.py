"""PyTorch port: the 2D and 3D backend's solvers as the JAX package runs
them (``utils/graphs.py``'s `while_loop` and `solve_loop`, ``solvers/pcg``'s
`cg_loop`): stopping tests on the device, loops in blocks of masked steps,
each block a CUDA graph on the card.

On the CPU: the blocked, masked `pcg` is bit-equal to the eager one (x,
r.z, count) for blocks of 1, 3, 8 and more than `max_iters` on random SPD
block systems (hypothesis), a right-hand side that stops at once and one
that hits the cap among them; `optimize_se2_schur` (both
preconditioners), `optimize_se2` (jacobi, chain), `optimize_se3` (jacobi,
chain) and `optimize_se2_direct` are bit-equal to verbatim copies of their
loops before this form (``tests/pre_graph_solvers.py``) and to their
"eager" mode, on small simulated worlds, for several block sizes. With the
CUDA graph replaced by a stand-in that runs the captured function on each
replay (`StandIn`), the captured paths (`_Blocks`, `_Chain`) run here too:
the same bits, the second-call rule (a key seen once captures nothing;
`landmark_covariance_se2`'s stage alike), one host read a block and one an
LM iteration, and launch counts under replay equal to an eager run of the
same masked steps. The JAX package's own solvers are held against the
port in ``test_torch_se2.py`` and ``test_torch_schur.py``, unchanged. On
the card (skipped here): ``tools/graph_probe.py``'s solver checks, every
graphed solve bit-equal to its eager mode, and a capture that fails
raising; the landmark solvers and tracker2d's and line SLAM's per-frame
stages (``tests/test_torch_landmark_graphs.py``) replayed against their
eager mode and bodies.
"""
import contextlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.slam.simulator import Simulator3DConfig, SimulatorConfig, simulate, simulate_se3
from g2o_frontend_tpu_torch.solvers import pcg
from g2o_frontend_tpu_torch.solvers import pose_graph as pg
from g2o_frontend_tpu_torch.solvers import schur_pcg as sp
from g2o_frontend_tpu_torch.utils import graphs
from tests import pre_graph_solvers as pre


def bits(*pairs):
    """Every (a, b) equal bit for bit: tensors by shape, dtype and bytes,
    anything else by ==."""
    for a, b in pairs:
        if torch.is_tensor(a) or torch.is_tensor(b):
            if a.shape != b.shape or a.dtype != b.dtype or a.numpy().tobytes() != b.numpy().tobytes():
                return False
        elif a != b:
            return False
    return True


# -- pcg ------------------------------------------------------------------------------


def spd_blocks(seed, n, d):
    """A random SPD system of n blocks of d, as (A, b) numpy float32."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n * d, n * d))
    A = (M @ M.T / (n * d) + rng.uniform(0.05, 2.0) * np.eye(n * d)).astype(np.float32)
    return A, rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("block", [1, 3, 8, 45])
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 12), d=st.integers(1, 3),
       rhs=st.sampled_from(["random", "zero"]), max_iters=st.sampled_from([40, 4]))
def test_blocked_pcg_equals_the_eager_pcg(block, seed, n, d, rhs, max_iters):
    A, b = spd_blocks(seed, n, d)
    if rhs == "zero":
        b[:] = 0.0  # r.z = 0 at once: no iteration
    At, bt = torch.from_numpy(A), (torch.from_numpy(b),)

    def hvp(A_, v):
        return ((A_ @ v[0].reshape(-1)).reshape(n, d),)

    def precond(A_, r):
        return (r[0] / torch.diagonal(A_).reshape(n, d),)

    (x, ), k, rz = pre.pcg(lambda v: hvp(At, v), bt, lambda r: precond(At, r), max_iters=max_iters, rtol=1e-6)
    (xe, ), ke, rze = pcg.pcg(lambda v: hvp(At, v), bt, lambda r: precond(At, r), max_iters=max_iters, rtol=1e-6)
    (xb, ), kb, rzb = pcg.pcg_blocked(hvp, bt, precond, consts=At, max_iters=max_iters, rtol=1e-6, block=block)
    assert bits((x, xe), (rz, rze), (k, ke)) and bits((x, xb), (rz, rzb), (k, int(kb)))
    assert kb.dtype == torch.int64 and (k == 0 if rhs == "zero" else k > 0)
    if max_iters == 4 and rhs == "random" and n * d > 4:
        assert k == 4  # the cap binds


def test_blocked_pcg_hits_the_cap_and_stops_at_once():
    A, b = spd_blocks(3, 12, 3)
    At = torch.from_numpy(A)
    for rhs, want in ((b, 5), (0 * b, 0)):
        out = pcg.pcg_blocked(lambda A_, v: ((A_ @ v[0].reshape(-1)).reshape(12, 3),), (torch.from_numpy(rhs),),
                              lambda A_, r: r, consts=At, max_iters=5, rtol=1e-12, block=3)
        assert int(out[1]) == want


def test_masked_block_changes_no_bit_after_the_stop():
    loop = graphs.Loop(lambda c, s: s[1] < 3, lambda c, s: (s[0] * c + 1.0, s[1] + 1), 3, 7)
    s = graphs.masked_block(loop, torch.tensor(0.5), (torch.tensor(2.0), torch.tensor(0)))
    e = (torch.tensor(2.0), torch.tensor(0))
    for _ in range(3):
        e = (e[0] * 0.5 + 1.0, e[1] + 1)
    assert bits((s[0], e[0]), (s[1], e[1]))


# -- the solvers on small worlds --------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    cfg = SimulatorConfig(n_poses=60, n_landmarks=12, world_size=12.0, seed=3)
    world = simulate(cfg)
    g, _ = graph2d_from_log(world.to_g2o_log(), device="cpu")
    g0, _ = graph2d_from_log(world.to_g2o_log(with_landmarks=False), device="cpu")
    g3, _ = simulate_se3(Simulator3DConfig(n_poses=50, world_size=6.0, closure_min_gap=10, seed=2), device="cpu")
    return dict(landmarks=g, pose_only=g0, se3=g3)


SCHUR = dict(iters=6, cg_iters=40, lm_lambda0=1e-3)


def schur_out(out):
    gk, st_ = out
    return [gk.poses, gk.landmarks, st_.chi2, st_.lm_lambda, st_.cg_iters, st_.lm_iters]


def pg_out(out):
    gk, st_ = out
    return [gk.poses] + ([gk.landmarks] if hasattr(gk, "landmarks") else []) + [st_.chi2, st_.lm_lambda,
                                                                               st_.cg_iters]


def solver_cases(w):
    """name -> (the solver now, its pre-graph copy, the outputs to compare)."""
    g, g0, g3 = w["landmarks"], w["pose_only"], w["se3"]
    cases = {}
    for wb in (True, False):
        cases[f"schur, woodbury {wb}"] = (lambda wb=wb: sp.optimize_se2_schur(g, woodbury=wb, **SCHUR),
                                         lambda wb=wb: pre.optimize_se2_schur(g, woodbury=wb, **SCHUR), schur_out)
    for p in ("jacobi", "chain"):
        cases[f"se2 {p}"] = (lambda p=p: pg.optimize_se2(g, iters=4, cg_iters=30, precond=p),
                             lambda p=p: pre.optimize_se2(g, iters=4, cg_iters=30, precond=p), pg_out)
        cases[f"se2 pose-only {p}"] = (lambda p=p: pg.optimize_se2(g0, iters=3, cg_iters=25, precond=p),
                                       lambda p=p: pre.optimize_se2(g0, iters=3, cg_iters=25, precond=p), pg_out)
        cases[f"se3 {p}"] = (lambda p=p: pg.optimize_se3(g3, iters=3, cg_iters=30, precond=p),
                             lambda p=p: pre.optimize_se3(g3, iters=3, cg_iters=30, precond=p), pg_out)
    cases["direct"] = (lambda: pg.optimize_se2_direct(g, iters=8, lm_lambda0=1e-4),
                       lambda: pre.optimize_se2_direct(g, iters=8, lm_lambda0=1e-4), pg_out)
    return cases


CASES = ["schur, woodbury True", "schur, woodbury False", "se2 jacobi", "se2 chain", "se2 pose-only jacobi",
         "se2 pose-only chain", "se3 jacobi", "se3 chain", "direct"]


@pytest.mark.parametrize("block", [1, 5, 16])
@pytest.mark.parametrize("name", CASES)
def test_solver_equals_its_pre_graph_loop(monkeypatch, worlds, name, block):
    monkeypatch.setattr(pcg, "BLOCK", block)
    now, before, out = solver_cases(worlds)[name]
    a, b = out(now()), out(before())
    assert bits(*zip(a, b))
    with graphs.mode("eager"):
        assert bits(*zip(out(now()), b))


def test_schur_stats_keep_their_types(worlds):
    _, st_ = sp.optimize_se2_schur(worlds["landmarks"], **SCHUR)
    assert type(st_.cg_iters) is int and type(st_.lm_iters) is int and st_.chi2.shape == (SCHUR["iters"] + 1,)
    _, st2 = pg.optimize_se2(worlds["landmarks"], iters=2, cg_iters=10)
    assert type(st2.cg_iters) is int and st2.chi2.shape == (3,)


def test_zero_iterations(worlds):
    g = worlds["landmarks"]
    for out in (sp.optimize_se2_schur(g, iters=0), pg.optimize_se2(g, iters=0), pg.optimize_se2_direct(g, iters=0)):
        assert bits((out[0].poses, g.poses)) and out[1].chi2.shape == (1,)


# -- the captured paths with a stand-in for the CUDA graph --------------------------------


class StandIn:
    """A captured piece whose graph runs the captured function again on
    each replay, writing its outputs into the first run's tensors (as a
    replay refreshes a graph's outputs in place); the launch counters are
    left as `graphs._Piece.replay` sets them."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self, out):
        counts = graphs._counts()
        new = self.fn()
        graphs._set_counts(counts)
        for o, n in zip(graphs.flatten(out)[1], graphs.flatten(new)[1]):
            o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    """The card's path of `while_loop`, `solve_loop` and `Stage` on CPU
    tensors: devices read as CUDA, every capture a `StandIn`. Records the
    captures, host reads of the flags and the segment sums (counted as
    launches here)."""
    rec = dict(pieces=[], stage_captures=0)
    cuda = torch.device("cuda")
    monkeypatch.setattr(graphs, "_device", lambda name, tensors: cuda)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())

    def warm(device, fn):
        counts = graphs._counts()
        out = fn()
        graphs._set_counts(counts)
        return out

    def capture_piece(name, fn, device, reads, kept=True):
        # a capture runs nothing: what the function writes into the
        # buffers it reads is put back
        counts, saved = graphs._counts(), [r.clone() for r in reads]
        out = fn()
        for r, v in zip(reads, saved):
            r.copy_(v)
        launches = [b - a for a, b in zip(counts, graphs._counts())]
        graphs._set_counts(counts)
        piece = graphs._Piece(None, out, launches)
        standin = StandIn(fn)
        piece.graph = type("G", (), {"replay": lambda self_: standin.replay(piece.out)})()
        rec["pieces"].append((name, kept))
        return piece

    def stage_capture(self, desc, tensors, device, scan=None):
        rec["stage_captures"] += 1
        return type("G", (), {"replay": lambda self_, t: self.body(*graphs.unflatten(desc, t))})()

    real_sum = ss.segment_sum

    def counted_sum(values, seg):
        ss.launches += 1
        return real_sum(values, seg)

    monkeypatch.setattr(graphs, "_warm", warm)
    monkeypatch.setattr(graphs, "_capture_piece", capture_piece)
    monkeypatch.setattr(graphs.Stage, "_capture", stage_capture)
    monkeypatch.setattr(ss, "segment_sum", counted_sum)
    monkeypatch.setattr(graphs, "_CHAINS", {})
    monkeypatch.setattr(graphs, "_SOLVES_SEEN", set())
    return rec


@pytest.mark.parametrize("name", CASES)
def test_captured_paths_equal_the_pre_graph_loop(stand_in, worlds, name):
    now, before, out = solver_cases(worlds)[name]
    want = out(before())
    first = out(now())  # a key seen once: head and tail eager, the loop's blocks through _Blocks
    assert not any(kept for _, kept in stand_in["pieces"])  # no piece of a chain
    second = out(now())  # the key seen before: the chain captured
    third = out(now())  # and replayed
    kept = [n for n, k in stand_in["pieces"] if k]
    assert len(kept) == (2 if name == "direct" else 3)
    assert bits(*zip(first, want)) and bits(*zip(second, want)) and bits(*zip(third, want))


def test_second_call_rule(stand_in, worlds):
    g, g0 = worlds["landmarks"], worlds["pose_only"]
    pg.optimize_se2(g, iters=2, cg_iters=20)
    assert len(graphs._CHAINS) == 0 and len(graphs._SOLVES_SEEN) == 1
    pg.optimize_se2(g0, iters=2, cg_iters=20)  # other shapes: another key, seen once
    assert len(graphs._CHAINS) == 0 and len(graphs._SOLVES_SEEN) == 2
    pg.optimize_se2(g, iters=2, cg_iters=20)
    assert len(graphs._CHAINS) == 1
    pg.optimize_se2(g, iters=3, cg_iters=20)  # another trace length: another key
    assert len(graphs._CHAINS) == 1
    sp.landmark_covariance_se2(g)
    assert stand_in["stage_captures"] == 0
    sp.landmark_covariance_se2(g)
    assert stand_in["stage_captures"] == 1


def test_blocks_capture_at_their_second_call(stand_in):
    A, b = spd_blocks(5, 10, 3)
    At = torch.from_numpy(A)
    args = (lambda A_, v: ((A_ @ v[0].reshape(-1)).reshape(10, 3),), (torch.from_numpy(b),),
            lambda A_, r: (r[0] / torch.diagonal(A_).reshape(10, 3),))
    x, k, rz = pcg.pcg_blocked(*args, consts=At, max_iters=60, rtol=1e-7, block=4)
    assert int(k) > 8 and stand_in["pieces"] == [("pcg: loop block of 4", False)]
    x1, k1, rz1 = pcg.pcg(lambda v: args[0](At, v), args[1], lambda r: args[2](At, r), max_iters=60, rtol=1e-7)
    assert bits((x[0], x1[0]), (rz, rz1), (int(k), k1))
    stand_in["pieces"].clear()
    pcg.pcg_blocked(*args, consts=At, max_iters=3, rtol=1e-7, block=4)  # one block: nothing captured
    assert stand_in["pieces"] == []


def test_host_reads_a_block_and_an_lm_iteration(stand_in, worlds, monkeypatch):
    """One read of the CG flag a block, one of the report an LM iteration."""
    g = worlds["landmarks"]
    reads = []
    real_bool, real_tolist = torch.Tensor.__bool__, torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append("flag") or real_bool(t))
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: reads.append("report") or real_tolist(t))
    for _ in range(3):  # eager head and tail, then the chain's capture, then its replays
        reads.clear()
        _, st_ = sp.optimize_se2_schur(g, **SCHUR)
        flags = reads.count("flag")
        assert reads.count("report") == st_.lm_iters
        assert flags <= -(-st_.cg_iters // pcg.BLOCK) + st_.lm_iters


def test_launch_counts_under_replay_equal_the_masked_eager_run(stand_in, worlds):
    g = worlds["landmarks"]
    counts = []
    for mode in ("masked", "graph", "graph", "graph"):
        ss.launches = 0
        with graphs.mode(mode):
            sp.optimize_se2_schur(g, **SCHUR)
        counts.append(ss.launches)
    assert counts[0] > 0 and counts == [counts[0]] * 4


def test_tree_nodes_round_trip(worlds):
    g = worlds["landmarks"]
    seg = ss.SegmentIndex(g.pp_ij[:, 0], g.poses.shape[0])
    desc, leaves = graphs.flatten((g, seg))
    g2, seg2 = graphs.unflatten(desc, leaves)
    assert g2.poses is g.poses and seg2.n == seg.n and seg2.index is seg.index
    assert graphs.flatten((g.with_poses(g.poses + 1), seg))[0] == desc  # values are not part of the key
    other = graph2d_from_log(simulate(SimulatorConfig(n_poses=30, n_landmarks=4, seed=1)).to_g2o_log(),
                             device="cpu")[0]
    assert graphs.flatten((other, seg))[0] != desc


# -- on the card -----------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tools import graph_probe

    return graph_probe


@pytest.mark.cuda
def test_graphed_solves_equal_their_eager_mode_on_the_card():
    probe = _card()
    probe.check_solvers(torch.device("cuda"), small=True)


@pytest.mark.cuda
def test_failed_solve_capture_raises_on_the_card():
    probe = _card()
    assert "reads the host" in probe.check_solver_capture_failure(torch.device("cuda"))


@pytest.mark.cuda
def test_landmark_solves_replay_their_eager_mode_on_the_card():
    """Line SLAM's graph, the plane graph and BA, padded: three graphed
    calls bit-equal to the eager mode, replay launches as the masked run's
    (``tests/test_torch_landmark_graphs.py`` holds them on the CPU)."""
    probe = _card()
    probe.check_solvers(torch.device("cuda"), cases=probe.landmark_cases(torch.device("cuda")))


@pytest.mark.cuda
def test_per_frame_stages_replay_their_eager_bodies_on_the_card():
    """tracker2d's and line SLAM's per-frame stages: the capture and a
    replay bit-equal to the eager body, and to the stage in eager mode."""
    probe = _card()
    probe.check_landmark_stages(torch.device("cuda"))
