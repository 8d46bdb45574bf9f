"""The evaluation protocols that need no dataset (counterpart of the
dataset-free sections of ``scripts/evaluate.py``).

- ``grid_slam_gt``: submap grid SLAM over a simulated laser world against
  its ground truth and the odometry's (``eval_grid_slam_gt``);
- ``pwn_slam``: the ``pwn_slam`` command line on the synthetic 40-frame
  orbit (``eval_pwn_slam``);
- ``pwn_slam_long``: the stress run, 500 frames at 96x128 over three laps
  of a wandering loop, with an LRU cloud cache of fewer slots than
  keyframes, closure consensus under conflicting candidates, the map
  merger's ``collapse_redundant`` and ``optimize_hierarchical`` inside the
  loop, ATE against the ground truth (``eval_pwn_slam_long``);
- ``pwn_odometry_tum``: the ``pwn_odometry`` command line on a 640x480
  Kinect TUM sequence of the stress world at scale 2, with the 14-column
  benchmark file (``eval_pwn_odometry_tum``).

Each section prints one JSON line with the JAX function's keys and its
name under ``section``. Every file goes under ``--out`` (a fresh temporary
directory by default). ``pwn_odometry_tum`` reads the repository's
``eval_out/tum_seq`` when it is there and writes nothing into it; without
it the sequence is generated under ``--out``.

    python -m g2o_frontend_tpu_torch.apps.evaluate --only pwn_slam_long,grid_slam_gt --fast --out DIR
    python -m g2o_frontend_tpu_torch.apps.evaluate --device cpu --fast
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from . import make_tum_sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TUM_SEQ = os.path.join(REPO, "eval_out", "tum_seq")


def pwn_odometry_tum(fast, out_dir, device="cuda"):
    """pwn_odometry end to end on the TUM-format sequence of the stress
    world at scale 2; the ATE against its ground truth and the benchmark
    file's format (14 numbers a frame: ``pwn_benchmark.cpp:417-421``)."""
    from . import pwn_odometry

    seq = TUM_SEQ
    if not os.path.isfile(os.path.join(seq, "depth.txt")):
        seq = os.path.join(out_dir, "tum_seq")
        make_tum_sequence.main([seq, "--frames", str(60 if fast else 120)])
    bench_file = os.path.join(out_dir, "tum_benchmark.txt")
    out = pwn_odometry.run([seq, "--out", os.path.join(out_dir, "tum_traj.txt"), "--scale", "2", "--sensor",
                            "kinect", "--kf-fraction", "0.75", "--benchmark-out", bench_file, "--device", device])
    with open(bench_file) as fh:
        rows = [ln.split() for ln in fh if ln.strip()]
    if not all(len(r) == 14 for r in rows):
        raise RuntimeError("benchmark format broke")
    out["benchmark_rows"] = len(rows)
    out["benchmark_file"] = bench_file
    return out


def grid_slam_gt(fast, device="cuda"):
    """Grid SLAM against the simulator's ground truth, beside the odometry."""
    from ..slam.grid_slam import GridSlam2D, GridSlamConfig
    from ..slam.simulator import LaserWorldConfig, simulate_laser_world
    from ..utils.evaluation import ate_xy

    noise = (0.08, 0.05, 0.02)
    w = simulate_laser_world(LaserWorldConfig(n_poses=60 if fast else 120, n_beams=360, room=6.0, max_range=16.0,
                                              odom_noise=noise))
    slam = GridSlam2D(GridSlamConfig(map_half_size=8.4, scans_per_submap=12, min_match_score=30.0), device=device)
    slam.process_scan(*w["scans"][0], np.zeros(3, np.float32))
    for k in range(1, len(w["scans"])):
        slam.process_scan(*w["scans"][k], w["odom_deltas"][k - 1])
    slam.optimize(iters=10, cg_iters=100)
    est = np.asarray(slam.poses)
    gt = w["gt_poses"][: len(est)]

    def comp(a, d):
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], a[2] + d[2]])

    odo = [gt[0]]
    for d in w["odom_deltas"]:
        odo.append(comp(odo[-1], d))
    odo = np.asarray(odo)[: len(est)]
    return {
        "frames": int(len(est)),
        "odom_noise": noise,
        "ate_slam_m": float(ate_xy(est[:, :2], gt[:, :2])["rmse"]),
        "ate_odom_m": float(ate_xy(odo[:, :2], gt[:, :2])["rmse"]),
    }


def stress_run(gts, cloud_cache=True, device="cuda"):
    """The stress run's loop over camera poses `gts` (4x4, world): render,
    track, close, group, optimise and collapse, then the final solve and
    the ATE of the online trajectory and of the optimised keyframes.
    Returns (the JAX protocol's figures, the tracker).

    With `cloud_cache` the map merger fuses each retired keyframe's cloud
    into its survivor's through the tracker's cache; without it the merger
    has no cache and fuses nothing, as the JAX package's merger, whose
    ``_fuse_clouds`` never fuses."""
    from ..graph.reflector import MapReflector
    from ..pwn.aligner import AlignerConfig
    from ..pwn.converter import ConverterConfig
    from ..slam.map_closer import CloserConfig, MapCloser
    from ..slam.map_merger import MapMerger
    from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig
    from ..utils.synth import default_projector, render_planes_depth

    proj = default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    acfg = AlignerConfig(outer_iterations=6)
    tracker = PwnTracker(
        proj, ccfg, acfg,
        PwnTrackerConfig(new_frame_inliers_fraction=0.75, cache_slots=10, min_cloud_inliers=500),
        device=device,
    )
    closer = MapCloser(
        tracker.manager, tracker.cache, proj, acfg,
        CloserConfig(
            translational_distance=0.5,
            frame_min_nonzero_threshold=2000,
            frame_max_outliers_threshold=6000,
            frame_min_inliers_threshold=2000,
            consensus_min_times_checked=2,
        ),
    )
    reflector = MapReflector(tracker.manager, device=device)
    merger = MapMerger(tracker.manager, cloud_cache=tracker.cache if cloud_cache else None)
    n_retired = 0

    t0 = time.perf_counter()
    n_committed = 0
    n_candidates = 0
    kf_at_last_opt = 0
    hier_cg = {"coarse": 0, "fine": 0}
    for T in gts:
        m = tracker.process_frame(render_planes_depth(T, proj, device=device))
        if m["keyframe"] and tracker.n_keyframes > 2:
            before = len([r for r in tracker.manager.relations if r.is_closure])
            key_node = tracker.manager.nodes[-1]
            rels = closer.process_key_node(key_node)
            merger.process_key_node(key_node)  # level-1 stream grouping
            after = len([r for r in tracker.manager.relations if r.is_closure])
            n_candidates += max(after - before, 0) + len(rels)
            n_committed += len(rels)
            if rels or tracker.n_keyframes - kf_at_last_opt >= 6:
                _, hstats = reflector.optimize_hierarchical(iters=5, cg_iters=40)
                hier_cg["coarse"] += hstats["coarse_cg"]
                hier_cg["fine"] += hstats["fine_cg"]
                kf_at_last_opt = tracker.n_keyframes
                tracker.global_T = tracker.prev_kf_node.transform.copy()
                tracker.prev_kf_T = tracker.global_T.copy()
                # retire keyframes whose accepted closures put them on an
                # already-mapped pose
                n_retired += merger.collapse_redundant(translational_threshold=0.15, rotational_threshold=0.15)
    chi2, hstats = reflector.optimize_hierarchical(iters=10, cg_iters=60)
    hier_cg["coarse"] += hstats["coarse_cg"]
    hier_cg["fine"] += hstats["fine_cg"]
    wall = time.perf_counter() - t0

    est = tracker.trajectory_array()
    # the tracker's frame is anchored at the first camera pose
    T0_inv = np.linalg.inv(gts[0])
    gt = np.stack([T0_inv @ T for T in gts])[: len(est)]
    t_err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    # map-quality ATE: optimised keyframe poses against the ground truth
    kf_err = np.asarray([np.linalg.norm(node.transform[:3, 3] - gt[node.payload["frame"]][:3, 3])
                         for node in tracker.manager.nodes
                         if node.payload.get("frame") is not None and node.payload["frame"] < len(gt)])
    return {
        "frames": len(gts),
        "keyframes": tracker.n_keyframes,
        "keyframes_retired": n_retired,
        "keyframes_active": len(merger.active_nodes()),
        "cache_slots": tracker.cache.max_slots,
        "cache_evictions": tracker.cache.evictions,
        "cache_recomputes": tracker.cache.recomputes,
        "closures_committed": n_committed,
        "closure_candidates": n_candidates,
        "fallbacks": int(sum(m.get("fallback", False) for m in tracker.metrics)),
        "ate_rmse_m": float(np.sqrt(np.mean(t_err**2))),
        "ate_max_m": float(t_err.max()),
        "kf_ate_rmse_m": float(np.sqrt(np.mean(kf_err**2))),
        "final_chi2": float(chi2),
        "big_nodes": len([n for n in tracker.manager.nodes if n.level == 1]),
        "hier_cg_coarse": hier_cg["coarse"],
        "hier_cg_fine": hier_cg["fine"],
        "wall_s": round(wall, 1),
    }, tracker


def pwn_slam_long(fast=False, n_frames=None, cloud_cache=True, device="cuda"):
    """The stress run over `n_frames` frames (500, or 120 with `fast`) of
    three laps of the wandering loop: the JAX protocol's figures."""
    n_frames = n_frames or (120 if fast else 500)
    return stress_run([make_tum_sequence.wander_pose(k, n_frames) for k in range(n_frames)], cloud_cache, device)[0]


def pwn_slam(out_dir, device="cuda"):
    """The pwn_slam command line on the synthetic 40-frame orbit."""
    from . import pwn_slam as app

    return app.run(["--synthetic", "--frames", "40", "--out-map", os.path.join(out_dir, "pwn_map.npz"),
                    "--out-traj", os.path.join(out_dir, "pwn_traj.txt"), "--device", device])


# section -> its function of (fast, out_dir, device)
SECTIONS = {
    "grid_slam_gt": lambda fast, out_dir, device: grid_slam_gt(fast, device),
    "pwn_slam": lambda fast, out_dir, device: pwn_slam(out_dir, device),
    "pwn_slam_long": lambda fast, out_dir, device: pwn_slam_long(fast, device=device),
    "pwn_odometry_tum": pwn_odometry_tum,
}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(SECTIONS), help="comma-separated sections: " + ", ".join(SECTIONS))
    ap.add_argument("--fast", action="store_true", help="the protocols' short runs")
    ap.add_argument("--out", default=None, help="directory for every file written (default: a fresh temporary one)")
    ap.add_argument("--device", default="cuda", help="torch device of the runs")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    names = [s for s in args.only.split(",") if s]
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"evaluate: unknown sections {unknown}; the sections are {', '.join(SECTIONS)}")
    out_dir = args.out or tempfile.mkdtemp(prefix="evaluate_")
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        print(json.dumps({"section": name, **SECTIONS[name](args.fast, out_dir, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    main()
