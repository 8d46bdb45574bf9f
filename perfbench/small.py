"""Small copies of the configurations, for the CPU tests: the same files
with the camera at a quarter of its resolution (its radii, point counts
and inlier thresholds scaled as `apps/pwn_odometry.configs` scales them),
60 frames, and a 300-pose backend world, whose solves stop after at
most 20 LM iterations. Nothing else changes, but the limits: at a sixteenth of the pixels and six judged frames a sound run's
gaps read up to ~15x the full size's, so the tests hold the limits
`LIMIT_FACTOR` times wider (exact limits stay exact). The control and the
faults the tests plant read far beyond that."""
from __future__ import annotations

import argparse
import copy

from . import harness
from . import run as bench_run

LIMIT_FACTOR = 30


def config(name: str):
    bench = harness.benchmark()
    c = next(c for c in bench["configs"] if c["name"] == name)
    cfg = copy.deepcopy(harness.load_json(harness.ROOT / c["file"]))
    if "camera" in cfg:
        s = 4
        cam = cfg["camera"]
        cam.update(rows=cam["rows"] // s, cols=cam["cols"] // s, fx=cam["fx"] / s, fy=cam["fy"] / s,
                   cx=cam["cx"] / s, cy=cam["cy"] / s)
        conv = cfg["converter"]
        conv.update(min_image_radius=max(2, conv["min_image_radius"] // s),
                    max_image_radius=max(4, conv["max_image_radius"] // s),
                    min_points=max(10, conv["min_points"] // (s * s)))
        cfg["tracker"]["min_cloud_inliers"] = max(50, cfg["tracker"]["min_cloud_inliers"] // (s * s))
        cfg["sequence"]["frames"] = 60
    if "world" in cfg:
        cfg["world"].update(n_poses=300, n_landmarks=30, world_size=20.0, n_observations=160)
    return cfg


def make_run(workload: str, seed: int = 5, seconds: float = 1.0, trace: int = 0):
    """A `Run` of `workload` on the CPU at the small size, and the
    benchmark's description. The process's torch keeps to two threads, as
    the tests run in several workers."""
    import torch

    torch.set_num_threads(2)
    bench = harness.benchmark()
    w, c = harness.cell(bench, workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    run, bench, _ = bench_run.make_run(args, device="cpu", config=config(c["name"]))
    run.traffic = dict(run.traffic, judge_frames=6, warm_solves=1)
    if "solver_args" in run.traffic:
        args = run.traffic["solver_args"]
        run.traffic["solver_args"] = dict(args, iters=min(args["iters"], 20))
    run.limits = {k: v * LIMIT_FACTOR for k, v in run.limits.items()}
    return run, bench
