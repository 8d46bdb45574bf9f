"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload pwn_odom.live --seed 7 --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for. The cell (`BENCHMARK.json`'s workload) names a configuration file and
a traffic file; the traffic file names the driver that builds the inputs
from the seed, warms up, drives the program for the window and judges its
outputs against the plain reference. With ``--trace 0`` the result line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a torch.profiler trace (CUDA activity) of the window's
first ``trace_seconds`` and from the program's counters. Each compared number
and its limit are printed last on standard error and last in the result.

Exit codes: 0 with a result line; 2 for a bad command line or a missing
file; 3 without the cards the cell needs; 4 when JAX or the JAX package
was loaded; an exception's traceback otherwise.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_run(args, device="cuda", config=None):
    """The `Run` of a command line; `config` replaces the cell's
    configuration file (the CPU tests' small sizes)."""
    bench = harness.benchmark()
    w, c = harness.cell(bench, args.workload)
    return harness.Run(
        workload=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        config=config if config is not None else harness.load_json(harness.ROOT / c["file"]),
        traffic=harness.traffic(w["traffic"]), limits=harness.limits(args.workload), device=device,
    ), bench, w


def card_ok(chips: int):
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} card(s), the cell needs {chips}"
    return None


def execute(run: harness.Run, bench, t_start: float):
    """Set up, drive the window, judge; returns the result dict (without
    the device's name, which the caller adds) and the checks."""
    import torch

    drv = harness.driver(run.traffic["driver"])
    state = drv.setup(run)
    gc.collect()
    if run.device != "cpu":
        torch.cuda.synchronize()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    run.say("setup_s", f"{setup_s:.3f}", "of which", json.dumps({k: round(v, 3) for k, v in run.setup_parts.items()}))
    if run.trace:
        run.tracer = harness.Tracer(float(run.traffic.get("trace_seconds", run.seconds)))
        run.tracer.start()
        win = drv.window(run, state, run.seconds)
        run.tracer.stop()
    else:
        win = drv.window(run, state, run.seconds)
    peak = torch.cuda.max_memory_allocated() if run.device != "cpu" else 0
    checks = drv.judge(run, state)
    del state
    run.say("work", json.dumps({k: v if not isinstance(v, list) or len(v) <= 8 else f"{len(v)} values"
                                for k, v in run.counters.items()}))
    result = {"correct": all(c.ok for c in checks), "attempted": win.attempted, "failed": win.failed}
    if run.trace:
        tr = harness.reduce_trace(run.tracer.results)
        busy_s = tr.busy_s
        run.say("trace", f"{len(tr.device)} device activities, {len(tr.launches)} launches in "
                f"{run.tracer.window_s:.3f} s, busy {busy_s:.3f} s; the profiler took {run.tracer.spent:.3f} s")
        reading = harness.Reading(tr, run.counters, run.tracer.window_s, run.config)
        values = {}
        for m in harness.metrics_of(bench, "per_layer", run.workload):
            v = harness.layer_reader(m["name"])(reading)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = values
        result["device"] = {"busy_s": busy_s, "window_s": run.tracer.window_s}
        result["breakdown"] = harness.breakdown(tr)
    else:
        values = dict(win.metrics, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in harness.metrics_of(bench, "end_to_end", run.workload)}
        result["device"] = {}
    result["device"]["memory_peak_bytes"] = peak
    return result, checks


def main(argv=None):
    args = parse(argv)
    # one process with few threads: the host's numerics are small (4x4
    # poses, per-frame conversions), and idle worker threads only add noise
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    harness.env_for_caches()
    try:
        run, bench, w = make_run(args)
    except (KeyError, OSError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    problem = card_ok(int(w["chips"]))
    if problem:
        print(f"perfbench: no run: {problem}", file=sys.stderr)
        return 3
    import torch

    torch.set_num_threads(1)
    result, checks = execute(run, bench, T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: no result: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(w["chips"]),
                        **result["device"]}
    run.say("card", harness.card_facts())
    run.say("readings", json.dumps(run.readings))
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
