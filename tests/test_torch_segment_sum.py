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

- the kernel's schedule (``csrc/segment_sum.cu``: the launch layout, the
  split into long and short segments, the long blocks' walk and chunks,
  the short blocks' tiles) run as a CPU model, bit-equal to
  ``index_add_`` under hypothesis and on one segment of 100,000 rows; the
  index's metadata built with no host read (a ``TorchDispatchMode`` that
  fails on one); the layout's limits; the rule that sends a segment to the
  long path; the wrapper's geometry against the source's constants.

The CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py`` and by the card-only test here (``-m cuda``; on a
machine without JAX, ``python3 tools/segment_sum_probe.py``).
"""
import contextlib
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

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
aten = torch.ops.aten


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


# -- the kernel's schedule (csrc/segment_sum.cu), modelled on the CPU ---------------------------------------------


class NoHostRead(TorchDispatchMode):
    """Fails on every operation that reads a tensor's value on the host:
    ``item``, ``nonzero``, ``_local_scalar_dense`` and indexing by a
    boolean mask."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if packet in (aten.item, aten.nonzero, aten._local_scalar_dense, aten.masked_select):
            raise AssertionError(f"host read: {func}")
        if packet is aten.index and any(t is not None and t.dtype == torch.bool for t in args[1]):
            raise AssertionError(f"host read: {func} by a boolean mask")
        return func(*args, **(kwargs or {}))


def test_no_host_read_mode_catches_host_reads():
    x = torch.tensor([1.0, 0.0])
    for read in (lambda: x[0].item(), lambda: torch.nonzero(x), lambda: x[x > 0], lambda: float(x.sum())):
        with NoHostRead(), pytest.raises(AssertionError, match="host read"):
            read()


class _Walker:
    """csrc/segment_sum.cu's Walker: the chunks of long block b, list
    entries b, b + G, ... of the segments by length while they have at
    least long_min rows."""

    def __init__(self, seg, b, G, long_min, R):
        self.ids, self.lengths = seg.by_length.tolist(), seg.sorted_lengths.tolist()
        self.offsets = seg.offsets.tolist()
        assert long_min >= ss.LONG_ROWS
        self.G, self.long_min, self.R, self.i = G, long_min, R, b
        self._take(b)

    def _take(self, pos):
        start, length = (self.offsets[self.ids[pos]], self.lengths[pos]) if pos < len(self.ids) else (0, 0)
        self.s = self.ids[pos] if length >= self.long_min else -1
        self.k, self.end, self.fresh = start, start + length, True

    def next(self):
        if self.s < 0:
            return (-1, 0, 0, False, False)
        count = min(self.R, self.end - self.k)
        chunk = (self.s, self.k, count, self.fresh, self.k + count >= self.end)
        self.k += count
        self.fresh = False
        if self.k >= self.end:
            self.i += self.G
            self._take(self.i)
        return chunk


def kernel_model(values, seg, lay):
    """The kernel's schedule run on the CPU: the long blocks' walkers,
    their ring of staged chunks (issued NSTAGE - 1 ahead of the adds, each
    chunk's rows gathered as the copies gather them) and the adding
    thread's running sum across chunks; the short blocks' tiles, their
    window of segments and V consecutive outputs a thread. Every
    add is one float add in k order. Returns (out, the number of writes of
    each output); unwritten outputs stay NaN."""
    E, n, C = values.shape[0], seg.n, lay.C
    v = values.reshape(E, C)
    order, offsets = seg.order.tolist(), seg.offsets.tolist()
    total = n * C
    out = torch.full((total,), float("nan"), dtype=values.dtype)
    writes = torch.zeros(total, dtype=torch.int64)
    zero = torch.zeros((), dtype=values.dtype)
    row_bytes = C * lay.itemsize
    long_min = ss.long_threshold(seg.sorted_lengths, lay) if n else lay.long_min
    for b in range(lay.long_blocks):
        R = lay.rows_per_chunk
        assert R <= ss.THREADS * ss.ROWS_PER_THREAD and R * row_bytes <= lay.stage_bytes
        assert row_bytes % lay.copy_bytes == 0 and ss.LONG_HEAD + 4 * ss.NORD * R + ss.NSTAGE * lay.stage_bytes <= lay.smem
        walker = _Walker(seg, b, lay.long_blocks, long_min, R)
        if walker.s < 0:
            continue
        ring = [None] * ss.NSTAGE

        def issue(chunk, st):
            _, k, count, _, _ = chunk
            ring[st] = (chunk, v[torch.tensor(order[k:k + count], dtype=torch.int64)])

        for st in range(ss.NSTAGE - 1):
            issue(walker.next(), st)
        pending = walker.next()
        acc, q = torch.zeros(C, dtype=values.dtype), 0
        while True:
            (s, _, count, first, last), rows = ring[q % ss.NSTAGE]
            if count == 0:
                break
            issue(pending, (q + ss.NSTAGE - 1) % ss.NSTAGE)
            pending = walker.next()
            if first:
                acc = torch.zeros(C, dtype=values.dtype)
            for r in range(count):
                acc = acc + rows[r]
            if last:
                out[s * C:(s + 1) * C] = acc
                writes[s * C:(s + 1) * C] += 1
            q += 1
    V, flat = lay.outputs_per_thread, v.reshape(-1)
    for t in range(lay.short_blocks):
        base = t * lay.tile
        last = min(base + lay.tile, total) - 1
        j0, j1 = base // C, last // C
        offs = offsets[j0:j1 + 2]
        for tid in range(ss.THREADS):
            o0 = base + tid * V
            j, c = (o0 - j0 * C) // C, o0 % C
            for u in range(V):
                if o0 + u <= last and offs[j + 1] - offs[j] < long_min:
                    a = zero
                    for k in range(offs[j], offs[j + 1]):
                        a = a + flat[order[k] * C + c]
                    out[o0 + u] = a
                    writes[o0 + u] += 1
                c += 1
                if c == C:
                    c, j = 0, j + 1
    return out.reshape((n,) + values.shape[1:]), writes


def _skewed_case(E, n, C, dtype, seed, long_share=0.5, dump_share=0.1):
    """E rows into n segments, `long_share` of them into a few segments
    (so some reach the long path), a share into the dump slot, and some
    segments left empty."""
    rng = np.random.default_rng(seed)
    index = rng.integers(0, max(n, 1), E)
    if n:
        heavy = rng.choice(n, size=min(n, 3), replace=False)
        pick = rng.random(E) < long_share
        index[pick] = rng.choice(heavy, size=int(pick.sum()))
    index[rng.random(E) < dump_share] = n
    shape = (E,) if C == 1 else (E, C)
    return torch.from_numpy(index), torch.from_numpy(rng.normal(size=shape)).to(dtype)


def _hold_model(index, values, n, **lay_kw):
    seg = ss.SegmentIndex(index, n)
    C = math.prod(values.shape[1:])
    lay = ss.layout(values.shape[0], n, C, values.element_size(), **lay_kw)
    got, writes = kernel_model(values, seg, lay)
    want = ss.segment_sum_reference(values, seg)
    assert got.shape == want.shape
    assert torch.equal(writes, torch.ones_like(writes)), "an output was written other than once"
    assert torch.equal(got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)), "not the CPU's bits"
    return seg, lay


@contextlib.contextmanager
def constants(**values):
    """The segment-sum module's layout constants set to `values` inside
    the block."""
    old = {k: getattr(ss, k) for k in values}
    for k, v in values.items():
        setattr(ss, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(ss, k, v)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(E=st.integers(0, 400), n=st.integers(0, 24), C=st.sampled_from([1, 2, 3, 6, 9, 36]),
       dtype=st.sampled_from([torch.float32, torch.float64]), seed=st.integers(0, 2**31 - 1),
       long_share=st.sampled_from([0.0, 0.5, 0.9]), dump_share=st.sampled_from([0.0, 0.2]),
       sms=st.sampled_from([1, 2, 132]), per_sm=st.sampled_from([1, 4]),
       stage=st.sampled_from([1, 100, 256, ss.BIG_STAGE]), vector=st.booleans(),
       align=st.sampled_from([8, 16]), medium=st.sampled_from([ss.LONG_ROWS, 40, ss.MEDIUM_ROWS]))
def test_kernel_schedule_equals_index_add(E, n, C, dtype, seed, long_share, dump_share, sms, per_sm, stage, vector,
                                          align, medium):
    index, values = _skewed_case(E, n, C, dtype, seed, long_share, dump_share)
    # small chunks and few long blocks: many chunks a segment, many segments
    # a block; VECTOR_OUTPUTS 0: 16 bytes of outputs a thread wherever E <= n;
    # MEDIUM_ROWS 40: segments of 32-39 rows go short where the long ones
    # outnumber the long blocks
    with constants(SMALL_STAGE=stage, BIG_STAGE=stage, LONG_BLOCKS_PER_SM=per_sm,
                   VECTOR_OUTPUTS=0 if vector else ss.VECTOR_OUTPUTS, MEDIUM_ROWS=medium):
        _hold_model(index, values, n, sms=sms, align=align)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_schedule_on_one_segment_of_100000_rows(dtype):
    rng = np.random.default_rng(11)
    E = 100_000 + 50
    index = np.full(E, 1)
    index[rng.choice(E, 50, replace=False)] = rng.choice([0, 2, 3], 50)  # and short ones around it
    values = torch.from_numpy(rng.normal(size=(E, 3))).to(dtype)
    seg, lay = _hold_model(torch.from_numpy(index), values, 4)
    assert int(seg.sorted_lengths[0]) == 100_000 and lay.long_blocks >= 1 and -(-100_000 // lay.rows_per_chunk) > 50


def test_kernel_schedule_at_n_0_and_e_0():
    for E, n in ((0, 0), (0, 7), (5, 0)):
        values = torch.ones(E, 3)
        _hold_model(torch.full((E,), n, dtype=torch.int64), values, n)


def test_segment_index_metadata_without_host_reads():
    index, _ = _skewed_case(2000, 60, 1, torch.float32, seed=3, long_share=0.6)
    with NoHostRead():
        seg = ss.SegmentIndex(index, 60)
        order, offsets, by_length, sorted_lengths = seg.order, seg.offsets, seg.by_length, seg.sorted_lengths
        ss.segment_sum(torch.ones(2000), seg)
    assert by_length.dtype == torch.int64 and sorted_lengths.dtype == torch.int32 and sorted_lengths.shape == (60,)
    lengths = (offsets[1:] - offsets[:-1]).numpy()
    np.testing.assert_array_equal(lengths, np.bincount(index.numpy(), minlength=61)[:60])
    assert int(offsets[-1]) == int((index < 60).sum())
    bl = by_length.numpy()
    assert sorted(bl.tolist()) == list(range(60))  # a permutation: each segment listed once
    np.testing.assert_array_equal(bl, np.argsort(-lengths, kind="stable"))  # longest first, ties in order
    np.testing.assert_array_equal(sorted_lengths.numpy(), lengths[bl])
    # each segment takes exactly one path: the long ones lead the list, and
    # a long block stops at the first entry below LONG_ROWS
    is_long = sorted_lengths.numpy() >= ss.LONG_ROWS
    n_long = int(is_long.sum())
    assert n_long > 0 and is_long[:n_long].all() and not is_long[n_long:].any()


# (segments of long_rows rows, segments of 1-9 rows, SMs, the threshold the
# kernel takes): the counts of phase 14 (e)'s sums (Schur's pose sums, its
# landmark sums, voxels at 0.02 and 0.1 m, the line solve's landmark sums),
# some scaled down by the SMs; and an index too small for a long block
RULE_CASES = [((0, (1, 1)), 300, 132, ss.LONG_ROWS),
              ((139, (200, 521)), 12, 132, ss.LONG_ROWS),
              ((1835, (32, 122)), 3000, 132, ss.MEDIUM_ROWS),
              ((1042, (32, 1199)), 3000, 132, ss.MEDIUM_ROWS),
              ((38, (32, 123)), 166, 132, ss.LONG_ROWS),
              ((6, (32, 100)), 40, 1, ss.MEDIUM_ROWS),
              ((0, (1, 1)), 3, 132, ss.INT32_MAX)]


@pytest.mark.parametrize("long_segments, short, sms, want", RULE_CASES)
def test_long_path_rule(long_segments, short, sms, want):
    """A segment takes the long path from LONG_ROWS rows, but from
    MEDIUM_ROWS where more segments have LONG_ROWS rows than there are long
    blocks (with per_sm 1 on one SM, G = 1); every segment takes one path
    and the sum equals ``index_add_`` in the model wherever it is small
    enough to run there."""
    rng = np.random.default_rng(len(RULE_CASES) + short)
    count, (lo, hi) = long_segments
    lengths = np.r_[rng.integers(lo, hi + 1, count), rng.integers(1, 10, short)]
    lengths[:count] = np.maximum(lengths[:count], lo)
    if count:
        lengths[0] = hi
    n = lengths.size
    index = torch.from_numpy(rng.permutation(np.repeat(np.arange(n), lengths)))
    seg = ss.SegmentIndex(index, n)
    with constants(LONG_BLOCKS_PER_SM=1 if sms == 1 else ss.LONG_BLOCKS_PER_SM):
        lay = ss.layout(index.numel(), n, 1, 4, sms=sms)
        assert ss.long_threshold(seg.sorted_lengths, lay) == want
        if index.numel() <= 20_000:
            _hold_model(index, torch.from_numpy(rng.normal(size=index.numel())).float(), n, sms=sms)


def test_kernel_constants_match_the_source():
    """The wrapper's geometry is the one ``csrc/segment_sum.cu`` declares
    (the built library is checked the same way when it loads)."""
    src = ss.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))

    def value(name):
        return eval(consts[name], {}, {k: value(k) for k in consts if k != name and k in consts[name]})

    assert (value("THREADS"), value("RPT"), value("NSTAGE"), value("NORD"), value("VEC_BYTES"),
            value("MAX_SMEM")) == (ss.THREADS, ss.ROWS_PER_THREAD, ss.NSTAGE, ss.NORD, ss.VECTOR_BYTES, ss.MAX_SMEM)
    # LONG_HEAD = NREC chunk records of 4 ints and a 32-byte Walk
    assert value("NREC") == ss.NSTAGE + 3 and ss.LONG_HEAD == value("NREC") * 16 + 32
    assert "int segment_sum_constants(int* out)" in src


@pytest.mark.parametrize("E, n, C, itemsize", [(3000, 151, 3, 4), (160000, 200, 36, 4), (160000, 200, 6, 4),
                                               (20803, 1075120, 6, 4), (14000, 7120, 3, 8), (614400, 614400, 4, 4),
                                               (0, 5, 3, 4), (100, 3, 300, 4), (40, 2, 256, 8)])
def test_layout(E, n, C, itemsize):
    lay = ss.layout(E, n, C, itemsize)
    if lay.short_blocks > ss.MANY_SHORT_BLOCKS_PER_SM * 132:  # then 8 blocks of 256 threads fit an SM
        assert 8 * (lay.smem + 1024) <= 228 * 1024
    assert lay.short_blocks * lay.tile >= n * C > (lay.short_blocks - 1) * lay.tile
    sparse = n * C >= ss.VECTOR_OUTPUTS and E <= n
    assert lay.outputs_per_thread == (ss.VECTOR_BYTES // itemsize if sparse else 1)
    assert lay.tile == ss.THREADS * lay.outputs_per_thread
    if lay.long_blocks:
        row = C * itemsize
        assert lay.long_min == ss.LONG_ROWS and lay.medium_min == ss.MEDIUM_ROWS and C <= ss.THREADS
        assert lay.long_blocks <= min(n, E // ss.LONG_ROWS, ss.LONG_BLOCKS_PER_SM * 132)
        assert row % lay.copy_bytes == 0 and lay.copy_bytes >= itemsize
        assert 1 <= lay.rows_per_chunk <= ss.THREADS * ss.ROWS_PER_THREAD and lay.rows_per_chunk * row <= lay.stage_bytes
        assert lay.stage_bytes % 16 == 0 and (lay.stage_bytes <= ss.BIG_STAGE or lay.rows_per_chunk == 1)
    else:
        assert lay.long_min == lay.medium_min == ss.INT32_MAX
    with pytest.raises(ValueError):
        ss.layout(E, n, C, 2)


@pytest.mark.cuda
def test_kernel_on_the_card_on_each_path():
    """The kernel against its plain version on the card, bit for bit, on
    each path (`tools/segment_sum_probe.check_paths`: long segments, one of
    100,000 rows and many of 32-300; short ones one output a thread and 16
    bytes a thread; C = 1-36; the dump slot and empty segments; float32
    and float64), two launches equal and equal to the previous design; and
    an index built and summed inside a CUDA graph capture, replayed, then
    summed again outside it (`check_capture`). This file imports JAX, which
    the card's machine lacks: there the same checks run as ``python3
    tools/segment_sum_probe.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tools import segment_sum_probe

    assert len(segment_sum_probe.check_paths(torch.device("cuda"))) == 10
    assert all(segment_sum_probe.check_capture(torch.device("cuda")).values())
