"""Pose-graph optimizer command line (counterpart of
``g2o_frontend_tpu/apps/graph_optimizer.py``): load a .g2o, optimize it,
write it back, print one JSON line.

Handles SE2 graphs (with XY landmarks) and SE3 graphs, with the LM/PCG
solvers of `solvers/pose_graph.py` on `--device`. With ``--devices N`` (N >
1) an SE2 graph is solved with its edges sharded over N shards
(`parallel/sharded_pose_graph.py`, which has no robust kernel: ``--huber``
is not applied there, as in the JAX app): a `ProcessMesh` of N ranks when
the program runs under ``torch.distributed``, else N shards stacked on
`--device`. SE3 graphs take the single-device solver either way.

Usage:
  python -m g2o_frontend_tpu_torch.apps.graph_optimizer IN.g2o[.gz]
      [-o OUT.g2o] [--iters 15] [--cg-iters 100] [--huber D]
      [--device cuda] [--devices N]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="optimized.g2o")
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--huber", type=float, default=None)
    ap.add_argument("--device", default="cuda", help="torch device of the graph and the solve")
    ap.add_argument("--devices", type=int, default=0, help="shard edges over N devices (0 = single)")
    return ap


def run(argv=None) -> dict:
    """Parse `argv`, optimize, write the output; returns the result dict."""
    args = _parser().parse_args(argv)

    from ..graph.store import graph2d_from_log, graph3d_from_log
    from ..io.g2o import read_g2o, write_g2o
    from ..solvers import pose_graph as pg

    log = read_g2o(args.input)
    is3d = len(log.se3_ids) > 0
    if is3d:
        g, _ = graph3d_from_log(log, device=args.device)
        chi2_0 = float(pg.chi2_se3(g))
        g_opt, stats = pg.optimize_se3(g, iters=args.iters, cg_iters=args.cg_iters, huber_delta=args.huber)
        trace = stats.chi2
        log.se3_poses = g_opt.poses.cpu().numpy().astype(np.float64)[: len(log.se3_ids)]
    else:
        g, _ = graph2d_from_log(log, device=args.device)
        chi2_0 = float(pg.chi2_se2(g))
        if args.devices > 1:
            from ..parallel.mesh import make_mesh
            from ..parallel.sharded_pose_graph import optimize_se2_sharded

            g_opt, trace = optimize_se2_sharded(g, make_mesh(args.devices, args.device), iters=args.iters,
                                                cg_iters=args.cg_iters)
        else:
            g_opt, stats = pg.optimize_se2(g, iters=args.iters, cg_iters=args.cg_iters, huber_delta=args.huber)
            trace = stats.chi2
        log.se2_poses = g_opt.poses.cpu().numpy().astype(np.float64)[: len(log.se2_ids)]
        if len(log.xy_ids):
            log.xy_points = g_opt.landmarks.cpu().numpy().astype(np.float64)[: len(log.xy_ids)]
    write_g2o(args.output, log)
    return {
        "dim": 3 if is3d else 2,
        "chi2_initial": chi2_0,
        "chi2_final": float(trace[-1]),
        "output": args.output,
    }


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
