"""The 2D backend user: a `.g2o` graph in, the optimum out, solve after
solve (a closed loop). Every solve starts afresh from the file's initial
estimate, so no state carries from one to the next.

Traffic parameters: ``entry``, the program's solver as a dotted path
(`module.function`, called as ``function(graph, **solver_args)``, returning
the solved graph and its stats), ``solver``, the name that the end-to-end
metric ``solve_s.<solver>`` takes, and the keyword arguments
``solver_args``;
``warm_solves``, the solves of set-up (a solve's graphs are captured at
its key's second call); ``trace_seconds``.

The world is generated from the seed (`gen/se2_world.py`) and written
once as a `.g2o` file in the run's temporary directory: the program reads
it with its own parser (`io.g2o.read_g2o`, `graph.store.graph2d_from_log`),
the reference parses the same text. The judge holds every solve of the
window to the float64 reference (`reference/se2.py`):

- ``chi2_start_gap``: the solve's first trace entry (its chi2 at the
  file's estimate) against the reference's, relative;
- ``chi2_end_gap``: its last entry against the reference's chi2 at the
  solve's own result, relative;
- ``optimum_gap``: the reference's chi2 at the solve's result over the
  reference's optimum, less 1;
- ``position_gap_m``: the largest distance of a pose's or a landmark's
  position from the float64 optimum's;
- ``heading_gap_rad``: the largest gap of a pose's heading from the
  optimum's;
- ``fixed_moved``: how far the fixed vertex moved from the file's value
  in the program's float32 (exact: 0).
"""
from __future__ import annotations

import importlib
import os
import tempfile
import time

import numpy as np
import torch

from .. import harness
from ..gen import se2_world
from ..reference import se2 as ref
from ..reference.precision import no_tf32


class State:
    pass


def _solver(run):
    module, name = run.traffic["entry"].rsplit(".", 1)
    fn, kw = getattr(importlib.import_module(module), name), dict(run.traffic["solver_args"])
    return lambda g: fn(g, **kw)


def setup(run):
    t = time.perf_counter()
    from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
    from g2o_frontend_tpu_torch.io import g2o
    from g2o_frontend_tpu_torch.utils import graphs

    st = State()
    st.graphs = graphs
    run.setup_parts["import"] = time.perf_counter() - t
    t = time.perf_counter()
    st.text = se2_world.g2o_text(run.config["world"], run.seed)
    run.setup_parts["world"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world.g2o")
        with open(path, "w") as fh:
            fh.write(st.text)
        log = g2o.read_g2o(path)
    st.g, _ = graph2d_from_log(log, device=run.device)
    run.setup_parts["parse"] = time.perf_counter() - t
    st.solve = _solver(run)
    t = time.perf_counter()
    for _ in range(int(run.traffic["warm_solves"])):
        _sync(run, st.solve(st.g))
    run.setup_parts["warm_solves"] = time.perf_counter() - t
    st.outputs = []
    return st


def _sync(run, out):
    if run.device != "cpu":
        torch.cuda.synchronize()
    return out


def window(run, st, seconds):
    times, reads, outs = [], [], []
    t0 = time.perf_counter()
    traced = []
    while not times or time.perf_counter() - t0 - run.traced_seconds() < seconds:
        traced.append(run.tracing)
        r0 = st.graphs.host_reads
        s0 = time.perf_counter()
        g_out, stats = st.solve(st.g)
        _sync(run, None)
        times.append(time.perf_counter() - s0)
        reads.append(st.graphs.host_reads - r0)
        outs.append((g_out.poses, g_out.landmarks, stats))
        run.poll(time.perf_counter() - t0)
    total = time.perf_counter() - t0
    st.outputs = outs
    # `SchurStats` counts LM and CG iterations; `OptStats.cg_iters` counts
    # the LM iterations of a direct solve
    iters = [int(s.lm_iters) if hasattr(s, "lm_iters") else int(s.cg_iters) for _, _, s in outs]
    run.counters.update(solves=len(outs), solve_s=times, host_reads=reads, lm_iters=iters, traced=traced)
    if all(hasattr(s, "lm_iters") for _, _, s in outs):
        run.counters["cg_iters"] = [int(s.cg_iters) for _, _, s in outs]
    return harness.Window(len(outs), 0, {f"solve_s.{run.traffic['solver']}": total / len(outs)})


def judge(run, st):
    """Every solve of the window against the float64 reference."""
    outs = [(p.double().cpu().numpy(), l.double().cpu().numpy(), s.chi2.double().cpu().numpy())
            for p, l, s in st.outputs]
    del st.g, st.outputs, st.solve
    if run.device != "cpu":
        torch.cuda.empty_cache()
    no_tf32()
    graph = ref.parse_g2o(st.text)
    prob = ref.Problem(graph, run.device, "float64")
    chi2_start = float(prob.chi2(torch.as_tensor(graph.poses, device=run.device),
                                 torch.as_tensor(graph.landmarks, device=run.device)))
    best_p, best_l, trace = ref.optimize(prob, graph.poses, graph.landmarks)
    best_p, best_l, optimum = best_p.cpu().numpy(), best_l.cpu().numpy(), trace[-1]
    fixed = np.where(graph.fixed)[0]
    start = graph.poses.astype(np.float32).astype(np.float64)  # the estimate as the program holds it
    seen, per_solve = {}, []
    for poses, lms, tr in outs:
        key = (poses.tobytes(), lms.tobytes(), tr.tobytes())
        if key not in seen:  # solves that agree bit for bit share the reference's work
            at = float(prob.chi2(torch.as_tensor(poses, device=run.device), torch.as_tensor(lms, device=run.device)))
            seen[key] = {
                "chi2_start_gap": abs(tr[0] / chi2_start - 1.0),
                "chi2_end_gap": abs(tr[-1] / at - 1.0),
                "optimum_gap": at / optimum - 1.0,
                "position_gap_m": float(max(np.linalg.norm(poses[:, :2] - best_p[:, :2], axis=1).max(),
                                            np.linalg.norm(lms - best_l, axis=1).max(initial=0.0))),
                "heading_gap_rad": float(np.abs(np.angle(np.exp(1j * (poses[:, 2] - best_p[:, 2])))).max()),
                "fixed_moved": float(np.abs(poses[fixed] - start[fixed]).max()) if len(fixed) else 0.0,
            }
        per_solve.append(seen[key])
    values = {k: harness.worst([v[k] for v in per_solve]) for k in per_solve[0]}
    run.say("reference", f"optimum chi2 {optimum!r} in {len(trace) - 1} LM iterations; {len(seen)} distinct results "
            f"of {len(outs)} solves")
    return harness.checks_from(run, values)


class _Solved:
    def __init__(self, poses, landmarks, chi2, iters):
        self.poses, self.landmarks, self.chi2 = poses, landmarks, chi2
        self.lm_iters = self.cg_iters = torch.tensor(iters)


def control(run, st, precision="tf32"):
    """Put the reference, computed in `precision`, in the program's place
    (the control of `correct`: it has to come out not correct); returns the
    function that puts the program back."""
    graph = ref.parse_g2o(st.text)
    prob = ref.Problem(graph, run.device, precision)

    def solve(_g):
        poses, lms, trace = ref.optimize(prob, graph.poses, graph.landmarks)
        out = _Solved(poses, lms, torch.tensor(trace, dtype=torch.float64), len(trace) - 1)
        return out, out

    program, st.solve = st.solve, solve

    def undo():
        st.solve = program

    return undo
