"""The port's spans on the card, in one benchmark cell: what a traced
window's spans say, and that they share the trace's clock.

    python3 tools/span_report.py --workload pwn_odom.live --seed 7 --seconds 3 [--out spans.jsonl]

Runs the cell as ``perfbench/run.py --trace 1`` runs it
(``perfbench.run.execute``: the driver's set-up, its window with the
profiler recording CUDA activity over the traffic's ``trace_seconds`` and
then `seconds` untraced, its judge, the per-layer readers), then reads the
traced window again. The JSON line holds:

- ``correct``, ``metrics``, ``device``: the run's result, as its result
  line gives them (the span readers, and ``launch_host_us``, whose
  counters time the replays made before the trace, among the metrics);
- ``requests``: the traced window's top-level spans (frames, scan calls,
  solves);
- ``clock``: every ``cudaGraphLaunch`` runtime event against the
  ``launch`` spans (the share inside one exactly and within 5 us, and the
  start and end offsets of each event in its span: min, median, max in
  ns); the ``cudaMemcpyAsync`` and synchronising events that start inside
  a ``host_read`` span (how many end after it); the synchronising events
  (``perfbench/spans.SYNCS``) that start inside a ``pwn_tracker.frame``
  span, and how many of those lie in neither a ``host_read`` nor an
  ``upload`` span;
- ``idle_ms_per_request``: the device's idle time by innermost span
  (``perfbench/spans.idle_by_innermost``) from the trace's or the spans'
  first event to their last, per request.

`traced` returns the same dict; the card tests of
``tests/test_torch_profiling.py`` call it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, spans  # noqa: E402
from perfbench import run as bench_run  # noqa: E402


def _quantiles(xs):
    return [min(xs), statistics.median(xs), max(xs)] if xs else None


def clock(trace, rec):
    """How the runtime's graph launches, copies and syncs sit in the spans."""
    launches = [e for e in trace.runtime if e[0].startswith("cudaGraphLaunch")]
    held = [(e, h) for e, h in zip(launches, spans.holders(launches, spans.intervals(rec, "launch"))) if h]
    reads = spans.intervals(rec, "host_read")
    copies = [e for e in trace.runtime if e[0].startswith("cudaMemcpyAsync") or spans.is_sync(e[0])]
    in_reads = [(e, h) for e, h in zip(copies, spans.holders(copies, reads)) if h]
    syncs = [e for e in trace.runtime if spans.is_sync(e[0])]
    frames = spans.intervals(rec, "pwn_tracker.frame")
    in_frames = [e for e, h in zip(syncs, spans.holders(syncs, frames)) if h]
    marked = spans.holders(in_frames, reads + spans.intervals(rec, "upload"))
    return {"graph_launches": len(launches), "launch_spans": len(spans.intervals(rec, "launch")),
            "inside": spans.inside(launches, rec, "launch"), "inside_5us": spans.inside(launches, rec, "launch", 5000),
            "start_offset_ns": _quantiles([e[1] - h[0] for e, h in held]),
            "end_offset_ns": _quantiles([h[1] - e[2] for e, h in held]),
            "host_read_spans": len(reads), "copies_and_syncs_in_host_reads": len(in_reads),
            "ending_after_their_read": sum(e[2] > h[1] for e, h in in_reads),
            "syncs_in_frames": len(in_frames), "syncs_in_frames_unmarked": sum(h is None for h in marked)}


def traced(workload, seed, seconds):
    """Run `workload`'s cell traced, `seconds` untraced after the trace."""
    import torch

    torch.set_num_threads(1)
    harness.env_for_caches()
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=1)
    run, bench, _ = bench_run.make_run(args)
    profiling = sys.modules.get("g2o_frontend_tpu_torch.utils.profiling")
    if hasattr(profiling, "clear_spans"):
        profiling.clear_spans()
    result, _ = bench_run.execute(run, bench, time.perf_counter())
    trace = harness.reduce_trace(run.tracer.results)
    rec = spans.program_spans() or []
    requests = len(spans.top(rec))
    bounds = [e[1:] for e in trace.device + trace.runtime] + [(s.start_ns, s.end_ns) for s in rec]
    lo, hi = min((b[0] for b in bounds), default=0), max((b[1] for b in bounds), default=0)
    idle = spans.idle_by_innermost(rec, trace.device, lo, hi) if rec else {}
    return {
        "workload": workload, "seed": seed, "card": harness.card_facts(), "correct": result["correct"],
        "metrics": {k: v["value"] for k, v in result["metrics"].items()}, "device": result["device"],
        "requests": requests, "clock": clock(trace, rec) if rec else None,
        "idle_ms_per_request": {k: v / 1e6 / max(requests, 1) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None, help="also append the line to this file")
    args = ap.parse_args(argv)
    line = json.dumps(traced(args.workload, args.seed, args.seconds))
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
