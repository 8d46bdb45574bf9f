"""Line SLAM over the 452-scan laser world, with witnesses that tell where
a run on one device parts from a run on another.

The world is `chip_smoke.py`'s phase 14 one (`simulate_laser_world` with
graphSE2.g2o's 452 scans, 360 beams, a 12 m room, 16 m range, odometry
noise (0.08, 0.05, 0.02), seed 0) through `models.build("line_slam")`,
then `merge_landmarks` and one final `optimize`. `--solves`:

- `device`: every solve on the run's device (what the port runs);
- `cpu`: each solve's graph copied to the CPU, solved there, and its
  poses and lines copied back: extraction and association stay on the
  device, so a run that then ends as the CPU's does says that the solves
  are where the two part.

`--lockstep` also drives a CPU run scan by scan beside it and reports the
first scan whose associations (the (pose, line) pairs of its observations)
differ, the solves before it, and how far each of those solves left the
poses and lines from the CPU's. Each of those solves of the device run is
also repeated on CPU copies of its own inputs: how far the two devices'
results lie apart on the same graph, and both chi2 traces (an LM step that
one device accepts and the other rejects shows there). Prints one JSON
line.

    python -m g2o_frontend_tpu_torch.apps.line_witness --lockstep
    python -m g2o_frontend_tpu_torch.apps.line_witness --solves cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from .. import models
from ..slam import line_slam as ls
from ..slam.simulator import LaserWorldConfig, simulate_laser_world
from ..utils.evaluation import ate_xy

WORLD = dict(n_poses=452, n_beams=360, room=12.0, max_range=16.0, odom_noise=(0.08, 0.05, 0.02), seed=0)


def odometry_path(gt0, deltas):
    """The poses that integrate `deltas` from `gt0` (SE2, numpy)."""
    odo = [np.asarray(gt0, np.float64)]
    for d in deltas:
        a = odo[-1]
        c, s = np.cos(a[2]), np.sin(a[2])
        odo.append(np.array([a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], a[2] + d[2]]))
    return np.asarray(odo)


@contextlib.contextmanager
def solves_on(target):
    """`slam.line_slam.optimize_line_graph` run on the device `target` inside
    the block: the graph copied there, the result copied back to the
    caller's."""
    original = ls.optimize_line_graph

    def moved(g, **kw):
        home = g.poses.device
        g_opt, trace = original(type(g)(*(t.to(target) for t in g)), **kw)
        return type(g)(*(t.to(home) for t in g_opt)), trace.to(home)

    ls.optimize_line_graph = moved
    try:
        yield
    finally:
        ls.optimize_line_graph = original


@contextlib.contextmanager
def solves_recorded(out):
    """Each solve of a graph off the CPU also run on CPU copies of the same
    graph, inside the block: appends (max |d pose|, max |d line|, the
    device's chi2 trace, the CPU's) to `out`. The device's result is kept."""
    original = ls.optimize_line_graph

    def both(g, **kw):
        g_opt, trace = original(g, **kw)
        if g.poses.device.type != "cpu":
            c_opt, c_trace = original(type(g)(*(t.cpu() for t in g)), **kw)
            out.append((float((g_opt.poses.cpu() - c_opt.poses).abs().max()),
                        float((g_opt.lines.cpu() - c_opt.lines).abs().max()), trace.cpu().tolist(),
                        c_trace.tolist()))
        return g_opt, trace

    ls.optimize_line_graph = both
    try:
        yield
    finally:
        ls.optimize_line_graph = original


def _pairs(drv):
    return [(p, l) for p, l, _, _ in drv.pl_edges]


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solves", choices=("device", "cpu"), default="device")
    ap.add_argument("--lockstep", action="store_true", help="drive a CPU run beside it, scan by scan")
    ap.add_argument("--scans", type=int, default=WORLD["n_poses"])
    args = ap.parse_args(argv)

    world = simulate_laser_world(LaserWorldConfig(**{**WORLD, "n_poses": args.scans}))
    gt = world["gt_poses"].astype(np.float64)
    drv = models.build("line_slam", device=args.device)
    ref = models.build("line_slam", device="cpu") if args.lockstep else None
    every = drv.cfg.optimize_each_n
    first_diff, solve_diffs, same_input = None, [], []
    t0 = time.perf_counter()
    with solves_on("cpu") if args.solves == "cpu" else contextlib.nullcontext(), \
            solves_recorded(same_input) if ref is not None else contextlib.nullcontext():
        for k in range(len(world["scans"])):
            odom = world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32)
            drv.process_scan(*world["scans"][k], odom)
            if ref is None or first_diff is not None:
                continue
            ref.process_scan(*world["scans"][k], odom)
            if _pairs(drv) != _pairs(ref):
                first_diff = k
            elif (k + 1) % every == 0:  # a solve ended this scan
                solve_diffs.append((float(np.abs(np.asarray(drv.poses) - np.asarray(ref.poses)).max()),
                                    float(np.abs(drv.lines - ref.lines).max())))
        merged = drv.merge_landmarks()
        chi2 = drv.optimize()
    seconds = time.perf_counter() - t0
    est = np.asarray(drv.poses, np.float64)
    out = {"device": str(drv.device), "solves": args.solves, "scans": len(world["scans"]), **drv.stats(),
           "merged": merged, "chi2": chi2, "ate_rmse_m": ate_xy(est[:, :2], gt[:, :2])["rmse"],
           "ate_odometry_m": ate_xy(odometry_path(gt[0], world["odom_deltas"])[:, :2], gt[:, :2])["rmse"],
           "seconds": seconds}
    if ref is not None:
        before = len(solve_diffs) if first_diff is None else first_diff // every
        out.update(first_assoc_diff_scan=first_diff, solves_before=before,
                   solve_diffs=[{"solve": i + 1, "pose_max_abs": p, "line_max_abs": q}
                                for i, (p, q) in enumerate(solve_diffs)],
                   same_input_solves=[{"solve": i + 1, "pose_max_abs": p, "line_max_abs": q, "trace": t,
                                       "cpu_trace": c} for i, (p, q, t, c) in enumerate(same_input[:before])])
    if torch.cuda.is_available() and drv.device.type == "cuda":
        out["gpu"] = torch.cuda.get_device_name(drv.device)
    return out


def main(argv=None):
    print(json.dumps(run(argv)), flush=True)


if __name__ == "__main__":
    main()
