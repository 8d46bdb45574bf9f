"""Full PWN SLAM command line (counterpart of
``g2o_frontend_tpu/apps/pwn_slam.py``, the pwn_slam_app equivalent).

Feeds every frame to `slam.pwn_slam.PwnSlam.process_frame`, which composes
the whole stack: depth -> cloud -> keyframe tracking -> partitioned
loop-closure search with consensus (candidates matched in one
`align_batch` per partition) -> periodic hierarchical pose-graph
optimization (the ``pwn_tracker2/pwn_slam_app.cpp:31`` flow); then runs the
final solve, writes the map checkpoint and the TUM trajectory, and prints
one JSON line.

Usage:
  python -m g2o_frontend_tpu_torch.apps.pwn_slam SEQ_DIR [--device cuda]
      [--conf FILE | --scale 4 --sensor kinect] [--kf-fraction F]
      [--max-frames N] [--optimize-each-n-keyframes 5] [--out-map M.npz]
      [--out-traj T.txt]
  python -m g2o_frontend_tpu_torch.apps.pwn_slam --synthetic --frames 48

``--conf`` reads a reference-format boss pipeline file (``pwn/pipeline.py``):
its projector at its scale, converter, aligner, closer and keyframe
fraction. The depth images are downscaled by the conf's scale (the JAX app
downscales them by ``--scale`` whatever the conf says, so there the two
must agree).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..io import tum
from ..io.checkpoint import save_map
from ..pwn.aligner import AlignerConfig
from ..pwn.converter import ConverterConfig
from ..pwn.pipeline import load_pipeline
from ..slam.map_closer import CloserConfig
from ..slam.pwn_slam import PwnSlam
from ..slam.pwn_tracker import PwnTrackerConfig
from ..utils import evaluation, lie
from ..utils.synth import default_projector, render_planes_depth
from .pwn_odometry import configs


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir", nargs="?", help="TUM sequence directory")
    ap.add_argument("--device", default="cuda", help="torch device of the clouds, alignments and solves")
    ap.add_argument("--synthetic", action="store_true", help="an orbit inside the synthetic room instead")
    ap.add_argument("--frames", type=int, default=48, help="frames of the synthetic orbit")
    ap.add_argument("--conf", help="reference-format boss pipeline conf")
    ap.add_argument("--scale", type=int, default=4, help="integer image downscale (without --conf)")
    ap.add_argument("--sensor", default="kinect", choices=sorted(tum.kinect_presets))
    ap.add_argument("--out-map", default="pwn_slam_map.npz")
    ap.add_argument("--out-traj", default="pwn_slam_traj.txt")
    ap.add_argument("--kf-fraction", type=float, default=None)
    ap.add_argument("--optimize-each-n-keyframes", type=int, default=5)
    ap.add_argument("--max-frames", type=int, default=0)
    return ap


def synthetic_configs():
    """Projector and converter/aligner/closer configs of the synthetic orbit,
    as the JAX command line builds them: a 96x128 camera, and the closer's
    frame gates scaled to that image area."""
    proj = default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    closer = CloserConfig(
        translational_distance=0.45,
        frame_min_nonzero_threshold=2000,
        frame_max_outliers_threshold=6000,
        frame_min_inliers_threshold=2000,
        consensus_min_times_checked=1,
    )
    return proj, ccfg, AlignerConfig(outer_iterations=6), closer


def synthetic_orbit(n_frames):
    """Camera poses of the synthetic orbit: a yawing loop inside the room."""
    poses = []
    for k in range(n_frames):
        a = 2 * np.pi * k / n_frames
        T = np.eye(4)
        T[:3, 3] = [0.6 * np.cos(a), 0.0, 0.3 * np.sin(a)]
        yaw = 0.35 * np.sin(a)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses.append(T)
    return poses


def run(argv=None) -> dict:
    """Parse `argv`, run the sequence, write the outputs; returns the result dict."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    kf_fraction = args.kf_fraction
    if args.conf:
        pipe = load_pipeline(args.conf)
        proj, ccfg, acfg, scale = pipe.scaled_projector(), pipe.converter_config, pipe.aligner_config, pipe.scale
        closer_cfg = pipe.closer_config or CloserConfig()
        if pipe.tracker_config is not None and kf_fraction is None:
            kf_fraction = pipe.tracker_config.new_frame_inliers_fraction
    elif args.synthetic:
        proj, ccfg, acfg, closer_cfg = synthetic_configs()
    else:
        proj, ccfg, acfg = configs(args.scale, args.sensor)
        closer_cfg, scale = CloserConfig(), args.scale
    if args.synthetic:
        frames = [
            (k / 30.0, render_planes_depth(T, proj, device=device)) for k, T in enumerate(synthetic_orbit(args.frames))
        ]
    else:
        if args.seq_dir is None:
            raise SystemExit("pwn_slam: give a sequence directory or --synthetic")
        index = tum.read_depth_index(args.seq_dir)
        if args.max_frames:
            index = index[: args.max_frames]
        frames = [(ts, tum.load_depth_png(os.path.join(args.seq_dir, rel))[::scale, ::scale]) for ts, rel in index]

    # synthetic orbits keep high overlap; the reference's 0.4 keyframe gate
    # would never fire there
    if kf_fraction is None:
        kf_fraction = 0.7 if args.synthetic else 0.4
    # minCloudInliers is a 640x480 scale-1 value (conf PwnTracker line);
    # scale it with the image area
    min_inl = max(50, int(3000 * (proj.rows * proj.cols) / (480 * 640)))
    # level-1 big-node layer (MapMerger stream grouping, map_merger.cpp:43)
    # feeds the coarse pass of optimize_hierarchical
    slam = PwnSlam(
        proj, ccfg, acfg, PwnTrackerConfig(new_frame_inliers_fraction=kf_fraction, min_cloud_inliers=min_inl),
        closer_cfg, optimize_each_n_keyframes=args.optimize_each_n_keyframes, device=device,
    )
    tracker = slam.tracker

    timestamps = []
    t0 = time.perf_counter()
    for ts, depth in frames:
        slam.process_frame(depth)
        timestamps.append(ts)
    chi2 = slam.finish()
    seconds = time.perf_counter() - t0
    save_map(args.out_map, tracker.manager)

    traj = tracker.trajectory_array()
    q = lie.mat2quat_full(torch.as_tensor(traj[:, :3, :3], dtype=torch.float32)).numpy()
    poses7 = np.concatenate([traj[:, :3, 3], q[:, 1:], q[:, :1]], 1)
    tum.write_trajectory(args.out_traj, timestamps, poses7)

    result = {
        "device": str(device),
        "frames": len(frames),
        "keyframes": tracker.n_keyframes,
        "closures": slam.n_closures,
        "batch_sizes": list(slam.closer.batch_sizes),
        "final_chi2": chi2,
        "frames_per_s": len(frames) / seconds,
        "map": args.out_map,
        "trajectory": args.out_traj,
    }
    gt_file = os.path.join(args.seq_dir, "groundtruth.txt") if args.seq_dir else ""
    if os.path.isfile(gt_file):
        ts_gt, gt7 = tum.read_trajectory(gt_file)
        result["ate"] = evaluation.ate(np.asarray(timestamps), poses7, ts_gt, gt7)
    return result


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
