"""The segment-sum kernel (``csrc/segment_sum.cu``) on the card: its paths
held against the CPU, its sums at the solvers' shapes timed against its
previous design and the atomic ``index_add_``, the cost of building an
index, and two solvers with each design.

1. `check_paths`: the kernel against its plain version, bit for bit, on
   each of its paths (long segments, one of 100,000 rows; many of 32-300
   rows; short ones one output a thread and 16 bytes a thread; C = 1, 6,
   9, 36; the dump slot and empty segments), float32 and float64: two
   launches of `segment_sum` bit-equal, and the previous design.
   `check_capture`: an index built and summed inside a CUDA graph
   capture, replayed, then summed again outside it. The card-only test of
   ``tests/test_torch_segment_sum.py`` calls both.
2. Synthetic sums at the shapes of phase 14 (d)'s BA (160,000 rows into
   200 cameras or 20,000 points), phase 12's pose sums (14,000 rows into
   7,120 poses), its Schur arrow (3,000 rows into 7,120 x 151 slots) and
   landmark sums, 2,000,000 rows into 151 long segments, BA's camera
   blocks at one segment an SM and one segment of 100,000 rows: the
   kernel, the previous design and the atomic ``index_add_`` in turns
   (CUDA graph replays) beside the bound.
3. `index_builds`: host microseconds a `SegmentIndex` build (synchronised,
   median of 200) at a line-SLAM extraction's, Schur's and a fusion's
   shapes, in turns with a build of the order and offsets alone (the
   previous design's index, without the segments by length that the long
   path reads).
4. `optimize_se2_schur` at phase 12's size (16 LM iterations) and
   `optimize_ba` at phase 14 (d)'s (10 LM iterations), in turns with the
   sums taken by the previous design and by the atomic ``index_add_``
   (atomic, previous, kernel, kernel, previous, atomic): wall seconds, ms
   a CG iteration, LM iterations/s, kernel launches, and whether two runs
   of each kind give the same traces.

One JSON line per measurement. Run from the repository root on a machine
with an H100 (the kernel is built from the checkout):

    python3 tools/segment_sum_probe.py [--no-solvers]
"""
import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import g2o_frontend_tpu_torch  # noqa: E402,F401  (turns TF32 off)
from g2o_frontend_tpu_torch.graph.store import graph2d_from_log  # noqa: E402
from g2o_frontend_tpu_torch.ops import segment_sum as ss  # noqa: E402
from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate  # noqa: E402
from g2o_frontend_tpu_torch.solvers import ba as tba  # noqa: E402
from g2o_frontend_tpu_torch.solvers import schur_pcg as sp  # noqa: E402
from g2o_frontend_tpu_torch.utils.profiling import gpu_name_and_power_limit  # noqa: E402

SHAPES = [(160000, 200, 36, "BA camera blocks"), (160000, 200, 6, "BA camera vectors"),
          (160000, 20000, 9, "BA point blocks"), (160000, 20000, 3, "BA point vectors"),
          (14000, 7120, 9, "pose blocks"), (14000, 7120, 3, "pose vectors"),
          (3000, 7120 * 151, 6, "Schur arrow"), (3000, 151, 3, "Schur landmarks"),
          (2_000_000, 151, 3, "2,000,000 rows into 151"), (118_008, 132, 36, "BA camera blocks, one an SM"),
          (100_000, 1, 3, "one segment of 100,000 rows")]


def path_cases(rng):
    """(label, index, n, C): one case a path of the kernel, each with a
    share of rows in the dump slot n."""
    cases = [("one segment of 100,000 rows and short ones", np.r_[np.full(100_000, 1), rng.integers(0, 4, 500)], 4,
              3),
             ("800 segments of ~75 rows, C = 36", rng.integers(0, 800, 60_000), 800, 36),
             ("1.1 M mostly empty segments, 16 bytes a thread", rng.integers(0, 1_100_000, 20_000), 1_100_000, 6),
             ("7,000 short segments, C = 9", rng.integers(0, 7_000, 14_000), 7_000, 9),
             ("3,000 segments of 32-300 rows, C = 1", np.repeat(np.arange(3000), rng.integers(32, 300, 3000)), 3000,
              1)]
    for label, index, n, C in cases:
        index = index.copy()
        index[rng.random(index.size) < 0.05] = n
        yield label, index, n, C


def check_paths(dev):
    """The kernel against the CPU's index_add_ on each path, two launches
    and the previous design; raises AssertionError on a difference.
    Returns one dict a case."""
    rng = np.random.default_rng(5)
    out = []
    for label, index, n, C in path_cases(rng):
        idx = torch.from_numpy(index)
        seg_c, seg = ss.SegmentIndex(idx.to(dev), n), ss.SegmentIndex(idx, n)
        for dtype in (torch.float32, torch.float64):
            values = torch.from_numpy(rng.normal(size=(index.size, C))).to(dtype)
            v = values.to(dev)
            before = ss.launches
            a, b = ss.segment_sum(v, seg_c), ss.segment_sum(v, seg_c)
            prev = ss._segment_sum_previous(v, seg_c)
            torch.cuda.synchronize()
            want = ss.segment_sum_reference(values, seg)
            lay = ss.layout(index.size, n, C, values.element_size())
            threshold, n_long = chip_smoke.long_segments(seg_c, lay)
            res = dict(case=label, dtype=str(dtype)[6:], long_from=threshold, long_segments=n_long,
                       long_blocks=lay.long_blocks, outputs_per_thread=lay.outputs_per_thread,
                       launches=ss.launches - before, equal_to_cpu=chip_smoke.same_bits((a, want)),
                       twice_equal=chip_smoke.same_bits((a, b)), previous_equal=chip_smoke.same_bits((prev, want)))
            out.append(res)
            assert res["launches"] == 2 and all(res[k] for k in res if k.endswith("equal") or k.endswith("cpu")), res
    return out


def check_capture(dev):
    """`chip_smoke.index_in_graph` on a case with long segments and on a
    sparse one: {case: whether both the replay and the sum after the
    capture equal the eager sum}."""
    rng = np.random.default_rng(7)
    out = {}
    for label, index, n, C in list(path_cases(rng))[1:3]:
        values = torch.from_numpy(rng.normal(size=(index.size, C)).astype(np.float32)).to(dev)
        out[label] = all(chip_smoke.index_in_graph(torch.from_numpy(index).to(dev), values, n).values())
    return out


def _order_and_offsets(index, n):
    """The previous design's index: the stable order and the offsets alone."""
    sorted_index, order = torch.sort(index, stable=True)
    bounds = torch.arange(n + 1, dtype=sorted_index.dtype, device=sorted_index.device)
    return order.to(torch.int32), torch.searchsorted(sorted_index, bounds, out_int32=True)


def index_builds(dev, reps=200):
    """Host microseconds a synchronised build (median of `reps`), in turns:
    the full `SegmentIndex` and the order and offsets alone."""
    rng = np.random.default_rng(3)
    for E, n, label in ((360, 360, "a line-SLAM extraction"), (20803, 7120, "Schur's pose sums"),
                        (20803, 151, "Schur's landmark sums"), (614400, 614400, "a fusion")):
        index = torch.from_numpy(rng.integers(0, n + 1, E)).to(dev)
        times = {"full": [], "order and offsets": []}
        for _ in range(reps):
            for kind, build in (("full", lambda: ss.SegmentIndex(index, n)),
                                ("order and offsets", lambda: _order_and_offsets(index, n))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                build()
                torch.cuda.synchronize()
                times[kind].append(1e6 * (time.perf_counter() - t0))
        print(json.dumps(dict(index_build=label, rows=E, segments=n,
                              **{f"{k}_us": float(np.median(v)) for k, v in times.items()})), flush=True)


@contextlib.contextmanager
def sums_by(kind):
    """`ops.segment_sum` on CUDA tensors taken by the previous design or by
    the atomic ``index_add_`` (its plain version) inside the block."""
    original = ss.segment_sum
    other = {"atomic": ss.segment_sum_reference, "previous": ss._segment_sum_previous}.get(kind)
    if other is not None:
        ss.segment_sum = lambda v, seg: other(v, seg) if v.is_cuda else original(v, seg)
    try:
        yield
    finally:
        ss.segment_sum = original


def shapes(dev):
    rng = np.random.default_rng(0)
    for E, n, C, label in SHAPES:
        idx = torch.from_numpy(rng.integers(0, n, E))
        v = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32))
        idx_c, v_c = idx.to(dev), v.to(dev)
        seg = ss.SegmentIndex(idx_c, n)
        a, b = ss.segment_sum(v_c, seg), ss.segment_sum(v_c, seg)
        cpu = ss.segment_sum_reference(v, ss.SegmentIndex(idx, n))
        d64 = ss.segment_sum(v_c.double(), seg).cpu()
        k_ms, prev_ms, lib_ms = chip_smoke.turns([lambda: ss.segment_sum(v_c, seg),
                                                  lambda: ss._segment_sum_previous(v_c, seg),
                                                  lambda: v_c.new_zeros((n, C)).index_add_(0, idx_c, v_c)], v_c)
        nbytes = E * C * 4 + E * 4 + (n + 1) * 4 + n * C * 4
        lengths = seg.offsets[1:] - seg.offsets[:-1]
        line = dict(sum=label, rows=E, segments=n, columns=C, longest=int(lengths.max()),
                    long_segments=chip_smoke.long_segments(seg, ss.layout(E, n, C, 4))[1],
                    equal_to_cpu=chip_smoke.same_bits((a, cpu)),
                    twice_equal=chip_smoke.same_bits((a, b)),
                    float64_equal_to_cpu=chip_smoke.same_bits((d64, ss.segment_sum_reference(
                        v.double(), ss.SegmentIndex(idx, n)))),
                    kernel_ms=k_ms, previous_ms=prev_ms, index_add_ms=lib_ms, bound_ms=nbytes / 3.35e12 * 1e3)
        print(json.dumps(line), flush=True)


def solvers(dev):
    g, _ = graph2d_from_log(simulate(SimulatorConfig(**chip_smoke.VICTORIA)).to_g2o_log(), device=dev)
    _, _, poses7, points, obs = chip_smoke.ba_world(**chip_smoke.BA_BIG)
    ba = tba.make_ba_problem(poses7, points, obs, device=dev)
    traces = {}
    for kind in ("atomic", "previous", "kernel", "kernel", "previous", "atomic"):
        with sums_by(kind):
            launches = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = chip_smoke.counted(lambda: sp.optimize_se2_schur(g, **chip_smoke.SCHUR_CAPS), launches, "schur")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, tr = chip_smoke.counted(lambda: tba.optimize_ba(ba, iters=10, cg_iters=50), launches, "ba")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        traces.setdefault(kind, []).append((st.chi2, tr))
        print(json.dumps(dict(sums=kind, schur_s=t1 - t0, schur_lm=st.lm_iters, schur_cg=st.cg_iters,
                              schur_ms_per_cg=1000.0 * (t1 - t0) / st.cg_iters, ba_s=t2 - t1,
                              ba_lm_per_s=10.0 / (t2 - t1), kernel_launches=launches,
                              schur_chi2=float(st.chi2[-1]), ba_chi2=float(tr[-1]))), flush=True)
    runs = {kind: chip_smoke.same_bits(*zip(*r)) for kind, r in traces.items()}
    runs["kernel_equals_previous"] = chip_smoke.same_bits(*zip(traces["kernel"][0], traces["previous"][0]))
    print(json.dumps({f"{k}_runs_equal" if k in traces else k: v for k, v in runs.items()}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-solvers", action="store_true", help="skip the Schur and BA solves")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    print(gpu_name_and_power_limit(), flush=True)
    _, secs, log = ss.build()
    print(json.dumps({"build_s": secs, "ptxas": chip_smoke.ptxas_lines(log)}), flush=True)
    dev = torch.device("cuda:0")
    for line in check_paths(dev):
        print(json.dumps(line), flush=True)
    captured = check_capture(dev)
    print(json.dumps({"index_built_in_a_graph_capture": captured}), flush=True)
    assert all(captured.values()), captured
    shapes(dev)
    index_builds(dev)
    if not args.no_solvers:
        solvers(dev)
    print(gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
