"""PyTorch port: ops/segment_sum.py (the deterministic segment sum that
replaces every float scatter-add on the card) against the JAX package, on
the CPU.

- `SegmentIndex` (stable order, offsets, the dump slot, empty segments) and
  the plain `segment_sum` against ``jax.ops.segment_sum`` for (E,) and
  (E, C) values, atol 1e-6;
- the plain version bit-equal to ``index_add_``, and to a float32 emulation
  of the kernel's arithmetic (each segment's rows added one by one in the
  stable order): on the same inputs the kernel equals the CPU;
- `compact_index` and the dense SE2 system assembled through it, bit-equal
  to block-by-block ``index_add_``; the halo's `_add_rows` equal to
  ``index_add``;
- every floating sum of `optimize_line_graph`, `optimize_se2_schur`,
  `optimize_ba` (and the other solvers of the port) goes through
  `segment_sum`: with ``Tensor.index_add_`` wrapped, no floating
  ``index_add_`` runs outside `segment_sum_reference`.

The CUDA kernel itself (``csrc/segment_sum.cu``) is held against this plain
version on the card by ``chip_smoke.py``.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.parallel import halo
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu_torch.solvers import ba as tba
from g2o_frontend_tpu_torch.solvers import line_slam as tls
from g2o_frontend_tpu_torch.solvers import pose_graph as tpg
from g2o_frontend_tpu_torch.solvers import schur_pcg as tsp
from tests.test_torch_line_slam import _problem as line_problem

torch.set_num_threads(1)


def _case(E, n, C, dump_share, seed):
    """Random rows into n segments (some left empty), a share of them into
    the dump slot n; values (E,) for C == 0, else (E, C)."""
    rng = np.random.default_rng(seed)
    live = rng.choice(n, size=max(1, n // 2), replace=False)  # the other half stay empty
    index = rng.choice(live, size=E)
    index[rng.random(E) < dump_share] = n
    shape = (E,) if C == 0 else (E, C)
    return index.astype(np.int64), rng.normal(size=shape).astype(np.float32)


CASES = [(200, 17, 0, 0.0), (200, 17, 0, 0.2), (500, 40, 6, 0.1), (64, 9, 36, 0.0), (0, 5, 3, 0.0), (50, 1, 2, 0.5)]


@pytest.mark.parametrize("E, n, C, dump", CASES)
def test_segment_index_order_and_offsets(E, n, C, dump):
    index, _ = _case(E, n, C, dump, seed=E + n)
    seg = ss.SegmentIndex(torch.from_numpy(index), n)
    order, offsets = seg.order.numpy(), seg.offsets.numpy()
    assert seg.order.dtype == torch.int32 and seg.offsets.dtype == torch.int32
    assert offsets.shape == (n + 1,) and offsets[0] == 0
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(index, minlength=n + 1)[:n])
    np.testing.assert_array_equal(order, np.argsort(index, kind="stable"))


@pytest.mark.parametrize("E, n, C, dump", CASES)
def test_segment_sum_matches_jax(E, n, C, dump):
    index, values = _case(E, n, C, dump, seed=E + n + 1)
    got = ss.segment_sum(torch.from_numpy(values), ss.SegmentIndex(torch.from_numpy(index), n)).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(index), num_segments=n))
    assert got.shape == want.shape == (n,) + values.shape[1:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("E, n, C, dump", CASES)
def test_plain_version_is_index_add_and_the_kernels_order(E, n, C, dump):
    index, values = _case(E, n, C, dump, seed=E + n + 2)
    idx, v = torch.from_numpy(index), torch.from_numpy(values)
    seg = ss.SegmentIndex(idx, n)
    got = ss.segment_sum(v, seg)
    direct = v.new_zeros((n + 1,) + v.shape[1:]).index_add_(0, idx, v)[:n]
    assert torch.equal(got, direct)
    # the kernel's arithmetic: per segment, acc = 0 then acc + row in the
    # stable order, in float32
    order, offsets = seg.order.numpy(), seg.offsets.numpy()
    rows = values.reshape(E, max(C, 1))
    emu = np.zeros((n, rows.shape[1]), np.float32)
    for s in range(n):
        acc = np.zeros(rows.shape[1], np.float32)
        for k in range(offsets[s], offsets[s + 1]):
            acc = (acc + rows[order[k]]).astype(np.float32)
        emu[s] = acc
    assert np.array_equal(emu.reshape(got.shape).view(np.int32), got.numpy().view(np.int32))


def test_float64_and_a_multi_axis_tail():
    index, values = _case(300, 12, 9, 0.1, seed=5)
    v = torch.from_numpy(values).double().reshape(300, 3, 3)
    got = ss.segment_sum(v, ss.SegmentIndex(torch.from_numpy(index), 12))
    assert got.shape == (12, 3, 3) and got.dtype == torch.float64
    want = np.zeros((13, 3, 3))
    np.add.at(want, index, v.numpy())
    np.testing.assert_allclose(got.numpy(), want[:12], rtol=0, atol=1e-12)


def test_segment_sum_rejects_bad_inputs():
    seg = ss.SegmentIndex(torch.tensor([0, 1, 1]), 2)
    with pytest.raises(ValueError, match="rows of values"):
        ss.segment_sum(torch.ones(4), seg)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ss.segment_sum(torch.ones(3, device="meta"), seg)


def test_compact_index_and_the_dense_system():
    index = torch.tensor([9_000_000_000, 5, 5, 77, 9_000_000_000, 5])
    ids, seg = ss.compact_index(index)
    assert ids.tolist() == [5, 77, 9_000_000_000] and seg.n == 3
    assert ss.segment_sum(torch.arange(6.0), seg).tolist() == [1.0 + 2.0 + 5.0, 3.0, 0.0 + 4.0]

    g, _ = graph2d_from_log(simulate(SimulatorConfig(n_poses=40, n_landmarks=6, seed=3)).to_g2o_log(), device="cpu")
    lin = tpg.linearize_se2(g)
    H, b = tpg._dense_system(g, lin)
    # the assembly before the segment sums: one index_add_ a block type
    NP, NL = g.poses.shape[0], g.landmarks.shape[0]
    D = 3 * NP + 2 * NL
    H0, b0 = g.poses.new_zeros(D * D), g.poses.new_zeros(D)

    def add(r0, c0, blk):
        rd, cd = torch.arange(blk.shape[-2]), torch.arange(blk.shape[-1])
        flat = (r0[:, None, None] + rd[None, :, None]) * D + (c0[:, None, None] + cd[None, None, :])
        H0.index_add_(0, flat.reshape(-1), blk.reshape(-1))

    def add_b(r0, vec):
        b0.index_add_(0, (r0[:, None] + torch.arange(vec.shape[-1])[None]).reshape(-1), vec.reshape(-1))

    ends = [(3 * g.pp_ij[:, 0], lin.Ji_pp, lin.w_pp, lin.e_pp), (3 * g.pp_ij[:, 1], lin.Jj_pp, lin.w_pp, lin.e_pp)]
    pl = [(3 * g.pl_ij[:, 0], lin.Jp_pl, lin.w_pl, lin.e_pl), (3 * NP + 2 * g.pl_ij[:, 1], lin.Jl_pl, lin.w_pl,
                                                                lin.e_pl)]
    for group in (ends, pl):
        for r0, Ja, w, _ in group:
            for c0, Jb, _, _ in group:
                add(r0, c0, torch.einsum("kdi,kdj->kij", Ja, torch.einsum("kde,kei->kdi", w, Jb)))
        for r0, Ja, w, e in group:
            add_b(r0, torch.einsum("kdi,kd->ki", Ja, torch.einsum("kde,ke->kd", w, e)))
    assert torch.equal(H, H0.view(D, D)) and torch.equal(b, b0)


def test_halo_add_rows_is_index_add():
    rng = np.random.default_rng(8)
    flat = torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, 45))
    rows = torch.from_numpy(rng.normal(size=(45, 3)).astype(np.float32))
    assert torch.equal(halo._add_rows(flat, idx, rows), flat.index_add(0, idx, rows))


@contextlib.contextmanager
def routed(monkeypatch):
    """Count `segment_sum` calls, and every floating ``index_add_`` made
    outside `segment_sum_reference`."""
    counts = {"segment_sum": 0, "stray": []}
    inside = [0]
    sum_fn, ref_fn, index_add = ss.segment_sum, ss.segment_sum_reference, torch.Tensor.index_add_

    def counted(values, seg):
        counts["segment_sum"] += 1
        return sum_fn(values, seg)

    def reference(values, seg):
        inside[0] += 1
        try:
            return ref_fn(values, seg)
        finally:
            inside[0] -= 1

    def watched(self, *args, **kw):
        if self.dtype.is_floating_point and not inside[0]:
            counts["stray"].append(tuple(self.shape))
        return index_add(self, *args, **kw)

    monkeypatch.setattr(ss, "segment_sum", counted)
    monkeypatch.setattr(ss, "segment_sum_reference", reference)
    monkeypatch.setattr(torch.Tensor, "index_add_", watched)
    yield counts


def _schur_graph():
    log = simulate(SimulatorConfig(n_poses=60, n_landmarks=8, seed=2)).to_g2o_log()
    return graph2d_from_log(log, device="cpu")[0]


def _ba():
    _, _, poses7, points, obs = chip_smoke.ba_world(n_poses=6, n_points=30, per_point=4)
    return tba.make_ba_problem(poses7, points, obs, device="cpu")


def _line_graph():
    _, lines_gt, poses_init, lines_init, pp, pl = line_problem()
    return tls.make_line_graph(poses_init, lines_init, pp, pl, device="cpu")


SOLVES = {
    "optimize_line_graph": lambda: tls.optimize_line_graph(_line_graph(), iters=3, cg_iters=20)[1],
    "optimize_se2_schur (Woodbury)": lambda: tsp.optimize_se2_schur(_schur_graph(), iters=3, cg_iters=30)[1].chi2,
    "optimize_se2_schur (chain)": lambda: tsp.optimize_se2_schur(_schur_graph(), iters=3, cg_iters=30,
                                                                 woodbury=False)[1].chi2,
    "optimize_ba": lambda: tba.optimize_ba(_ba(), iters=3, cg_iters=20)[1],
    "optimize_se2 (chain)": lambda: tpg.optimize_se2(_schur_graph(), iters=2, cg_iters=20, precond="chain")[1].chi2,
    "optimize_se2_direct": lambda: tpg.optimize_se2_direct(_schur_graph(), iters=2)[1].chi2,
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_solvers_route_every_sum_through_segment_sum(monkeypatch, name):
    with routed(monkeypatch) as counts:
        trace = SOLVES[name]()
    assert torch.isfinite(trace).all() and float(trace[-1]) < float(trace[0])
    assert counts["segment_sum"] > 0, f"{name} made no segment sum"
    assert not counts["stray"], f"{name} made floating index_add_ calls outside segment_sum: {counts['stray']}"
