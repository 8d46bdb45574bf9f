"""Readings of the compared numbers over many seeds in one process: the
program's, and the control's (the plain reference in the next precision
below the configuration's, put in the program's place), at the cell's own
size, with a short window each. The limits in ``limits/<cell>.json`` are
set between the two: above the program's largest reading, below the
control's smallest.

    python3 perfbench/control.py --workload pwn_odom.live --seconds 3 \\
        --seeds 101 102 103 --control-seeds 201 202 203

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number. Needs the card, like a run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from perfbench import run as bench_run  # noqa: E402


def readings(workload, seed, seconds, precision=None, device="cuda", config=None):
    """({number: value}, the window) of one seed; with `precision`, the
    reference in that precision stands in the program's place."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    run, _, _ = bench_run.make_run(args, device=device, config=config)
    drv = harness.driver(run.traffic["driver"])
    st = drv.setup(run)
    undo = drv.control(run, st, precision) if precision else None
    try:
        win = drv.window(run, st, seconds)
    finally:
        if undo:
            undo()
    drv.judge(run, st)
    return run.readings, win


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=None)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    harness.env_for_caches()
    problem = bench_run.card_ok(1)
    if problem:
        print(f"control: no run: {problem}", file=sys.stderr)
        return 3
    table = {"program": [], "control": []}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            secs = args.seconds if kind == "program" else (args.control_seconds or args.seconds)
            vals, win = readings(args.workload, seed, secs, "tf32" if kind == "control" else None)
            table[kind].append(vals)
            print(json.dumps({"kind": kind, "seed": seed, "attempted": win.attempted, "values": vals,
                              "seconds": round(time.perf_counter() - t, 2)}), flush=True)
    names = (table["program"] or table["control"] or [{}])[0].keys()
    summary = {n: {"program_max": max((v[n] for v in table["program"]), default=None),
                   "control_min": min((v[n] for v in table["control"]), default=None)} for n in names}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
