"""The segment-sum kernel (``csrc/segment_sum.cu``) on the card: its sums at
the solvers' shapes, and two solvers with it and with the atomic
``index_add_`` it replaced.

1. Synthetic sums at the shapes of phase 14 (d)'s BA (160,000 rows into
   200 cameras or 20,000 points), phase 12's pose sums (14,000 rows into
   7,120 poses), its Schur arrow (3,000 rows into 7,120 x 151 slots) and
   landmark sums, and 2,000,000 rows into 151 long segments: the kernel
   against the CPU's ``index_add_`` (bit for bit, float32 and float64),
   two launches bit-equal, and its time in turns with the atomic
   ``index_add_`` (CUDA graph replays) beside its bound.
2. `optimize_se2_schur` at phase 12's size (16 LM iterations) and
   `optimize_ba` at phase 14 (d)'s (10 LM iterations), in turns with the
   sums taken by the atomic ``index_add_`` (atomic, kernel, kernel,
   atomic): wall seconds, ms a CG iteration, LM iterations/s, kernel
   launches, and whether two runs of each kind give the same traces.

One JSON line per measurement. Run from the repository root on a machine
with an H100 (the kernel is built from the checkout):

    python3 tools/segment_sum_probe.py
"""
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
from g2o_frontend_tpu_torch.utils.profiling import gpu_name_and_power_limit, in_turns  # noqa: E402

SHAPES = [(160000, 200, 36, "BA camera blocks"), (160000, 200, 6, "BA camera vectors"),
          (160000, 20000, 9, "BA point blocks"), (160000, 20000, 3, "BA point vectors"),
          (14000, 7120, 9, "pose blocks"), (14000, 7120, 3, "pose vectors"),
          (3000, 7120 * 151, 6, "Schur arrow"), (3000, 151, 3, "Schur landmarks"),
          (2_000_000, 151, 3, "2,000,000 rows into 151")]


@contextlib.contextmanager
def atomic_sums():
    """`ops.segment_sum` on CUDA tensors replaced by its plain version, the
    atomic ``index_add_``, inside the block."""
    original = ss.segment_sum
    ss.segment_sum = lambda v, seg: ss.segment_sum_reference(v, seg) if v.is_cuda else original(v, seg)
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
        k_ms, lib_ms = in_turns(lambda: ss.segment_sum(v_c, seg),
                                lambda: v_c.new_zeros((n, C)).index_add_(0, idx_c, v_c), v_c, 20)
        nbytes = E * C * 4 + E * 4 + (n + 1) * 4 + n * C * 4
        print(json.dumps(dict(
            sum=label, rows=E, segments=n, columns=C,
            equal_to_cpu=chip_smoke.same_bits((a, cpu)), twice_equal=chip_smoke.same_bits((a, b)),
            float64_equal_to_cpu=chip_smoke.same_bits((d64, ss.segment_sum_reference(v.double(),
                                                                                   ss.SegmentIndex(idx, n)))),
            atomic_max_abs_diff=float((v_c.new_zeros((n, C)).index_add_(0, idx_c, v_c) - a).abs().max()),
            kernel_ms=k_ms, index_add_ms=lib_ms, bound_ms=nbytes / 3.35e12 * 1e3)), flush=True)


def solvers(dev):
    g, _ = graph2d_from_log(simulate(SimulatorConfig(**chip_smoke.VICTORIA)).to_g2o_log(), device=dev)
    _, _, poses7, points, obs = chip_smoke.ba_world(**chip_smoke.BA_BIG)
    ba = tba.make_ba_problem(poses7, points, obs, device=dev)
    traces = {}
    for sums in ("atomic", "kernel", "kernel", "atomic"):
        with atomic_sums() if sums == "atomic" else contextlib.nullcontext():
            launches = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = chip_smoke.counted(lambda: sp.optimize_se2_schur(g, **chip_smoke.SCHUR_CAPS), launches, "schur")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, tr = chip_smoke.counted(lambda: tba.optimize_ba(ba, iters=10, cg_iters=50), launches, "ba")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        traces.setdefault(sums, []).append((st.chi2, tr))
        print(json.dumps(dict(sums=sums, schur_s=t1 - t0, schur_lm=st.lm_iters, schur_cg=st.cg_iters,
                              schur_ms_per_cg=1000.0 * (t1 - t0) / st.cg_iters, ba_s=t2 - t1,
                              ba_lm_per_s=10.0 / (t2 - t1), kernel_launches=launches,
                              schur_chi2=float(st.chi2[-1]), ba_chi2=float(tr[-1]))), flush=True)
    print(json.dumps({f"{sums}_runs_equal": chip_smoke.same_bits(*zip(*runs)) for sums, runs in traces.items()}),
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    print(gpu_name_and_power_limit(), flush=True)
    _, secs, log = ss.build()
    print(json.dumps({"build_s": secs, "ptxas": chip_smoke.ptxas_lines(log)}), flush=True)
    dev = torch.device("cuda:0")
    shapes(dev)
    solvers(dev)
    print(gpu_name_and_power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
