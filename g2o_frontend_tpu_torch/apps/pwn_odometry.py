"""PWN RGB-D odometry command line (counterpart of
``g2o_frontend_tpu/apps/pwn_odometry.py``).

Runs the keyframe tracker over a TUM-style sequence (depth.txt + 16-bit
PNGs) or a synthetic orbit, writes the TUM trajectory, optionally the
per-frame benchmark file, and evaluates ATE against groundtruth.txt when
present (``pwn_odometry/pwn_odometry.cpp:20-46``). Prints one JSON line.

Usage:
  python -m g2o_frontend_tpu_torch.apps.pwn_odometry SEQ_DIR [--device cuda]
      [--conf FILE | --scale 2 --sensor kinect] [--kf-fraction 0.4]
      [--max-frames N] [--scan] [--out traj.txt] [--benchmark-out bench.txt]
  python -m g2o_frontend_tpu_torch.apps.pwn_odometry --synthetic [--frames 30]

``--conf`` reads a reference-format boss pipeline file (``pwn/pipeline.py``):
its projector at its scale, converter, aligner and keyframe fraction; the
depth images are downscaled by the conf's scale.
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

from ..pwn.aligner import AlignerConfig
from ..pwn.converter import ConverterConfig
from ..pwn.pipeline import load_pipeline
from ..pwn.projector import PinholeProjector
from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig, odometry_scan
from ..utils import evaluation, lie
from ..utils.synth import default_projector, render_planes_depth


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir", nargs="?", help="TUM sequence directory")
    ap.add_argument("--device", default="cuda", help="torch device of the clouds and alignments")
    ap.add_argument("--synthetic", action="store_true", help="an orbit inside the synthetic room instead")
    ap.add_argument("--frames", type=int, default=30, help="frames of the synthetic orbit")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--conf", help="reference-format boss pipeline conf")
    ap.add_argument("--scale", type=int, default=2, help="integer image downscale (without --conf)")
    ap.add_argument("--sensor", default="kinect", choices=sorted(tum.kinect_presets))
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kf-fraction", type=float, default=None, help="keyframe inlier fraction (default: the conf's, or 0.4)")
    ap.add_argument(
        "--scan",
        action="store_true",
        help="whole-sequence mode: the keyframe loop runs with no per-frame host "
        "synchronisation (odometry_scan); trajectory only, no map graph",
    )
    ap.add_argument(
        "--benchmark-out",
        help="per-frame benchmark file in the reference format: 'inliers error "
        "error/inliers time dist angle score x y z qx qy qz qw' (pwn_benchmark.cpp:417-421)",
    )
    return ap


def configs(scale, sensor):
    """Projector and converter/aligner configs of a TUM sequence at `scale`,
    as the JAX command line builds them."""
    fx, fy, cx, cy = tum.kinect_presets[sensor]
    s = scale
    proj = PinholeProjector(
        rows=480 // s, cols=640 // s, fx=fx / s, fy=fy / s, cx=cx / s, cy=cy / s,
        min_distance=0.3, max_distance=6.0,
    )
    ccfg = ConverterConfig(
        min_image_radius=max(2, 10 // s),
        max_image_radius=max(4, 30 // s),
        min_points=max(10, 50 // (s * s)),
    )
    return proj, ccfg, AlignerConfig(outer_iterations=10)


def synthetic_configs():
    """Projector and converter/aligner configs of the synthetic orbit, as
    the JAX command line builds them."""
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    return default_projector(H=120, W=160), ccfg, AlignerConfig(outer_iterations=6)


def synthetic_orbit(n_frames):
    """Camera poses of the synthetic orbit: a loop inside the room."""
    poses = []
    for k in range(n_frames):
        a = 2 * np.pi * k / n_frames
        T = np.eye(4)
        T[:3, 3] = [0.4 * np.cos(a), 0.0, 0.25 * np.sin(a)]
        poses.append(T)
    return poses


def run(argv=None) -> dict:
    """Parse `argv`, run the sequence, write the outputs; returns the result dict."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    kf_fraction = args.kf_fraction
    scale = args.scale
    if args.conf:
        pipe = load_pipeline(args.conf)
        proj, ccfg, acfg, scale = pipe.scaled_projector(), pipe.converter_config, pipe.aligner_config, pipe.scale
        if pipe.tracker_config is not None and kf_fraction is None:
            kf_fraction = pipe.tracker_config.new_frame_inliers_fraction
    elif args.synthetic:
        proj, ccfg, acfg = synthetic_configs()
    else:
        proj, ccfg, acfg = configs(args.scale, args.sensor)
    if kf_fraction is None:
        kf_fraction = 0.4
    min_inliers = max(50, int(3000 * (proj.rows * proj.cols) / (480 * 640)))
    tracker = PwnTracker(
        proj, ccfg, acfg,
        PwnTrackerConfig(new_frame_inliers_fraction=kf_fraction, min_cloud_inliers=min_inliers),
        device=device,
    )

    if args.synthetic:
        poses = synthetic_orbit(args.frames)
        timestamps = [k / 30.0 for k in range(len(poses))]
        depths = torch.stack([render_planes_depth(T, proj, device=device) for T in poses])
        depth_scale = None
    else:
        if args.seq_dir is None:
            raise SystemExit("pwn_odometry: give a sequence directory or --synthetic")
        index = tum.read_depth_index(args.seq_dir)
        if args.max_frames:
            index = index[: args.max_frames]
        timestamps = [ts for ts, _ in index]
        depths = np.stack([tum.load_depth_png_raw(os.path.join(args.seq_dir, rel))[::scale, ::scale]
                           for _, rel in index])
        depth_scale = 1.0 / 5000.0

    frame_times = []
    if args.scan:
        t0 = time.perf_counter()
        traj_dev, metrics = odometry_scan(
            depths, proj, ccfg, acfg, kf_fraction=kf_fraction,
            min_cloud_inliers=min_inliers, depth_scale=depth_scale, device=device,
        )
        traj = traj_dev.cpu().numpy().astype(np.float64)
        wall = time.perf_counter() - t0
        frame_times = [wall / len(traj)] * len(traj)
        tracker.trajectory = list(traj)
        tracker.n_keyframes = int(metrics["keyframe"].sum())
        tracker.metrics = [
            {"keyframe": bool(k), "inliers": int(i), "fraction": float(f), "chi2": 0.0}
            for k, i, f in zip(*(metrics[n].cpu().numpy() for n in ("keyframe", "inliers", "fraction")))
        ]
    else:
        for r in depths:
            depth = r if depth_scale is None else r.astype(np.float32) * np.float32(depth_scale)
            t0 = time.perf_counter()
            tracker.process_frame(depth)
            frame_times.append(time.perf_counter() - t0)

    traj = tracker.trajectory_array()
    q = lie.mat2quat_full(torch.as_tensor(traj[:, :3, :3], dtype=torch.float32)).numpy()
    poses7 = np.concatenate([traj[:, :3, 3], q[:, 1:], q[:, :1]], 1)
    tum.write_trajectory(args.out, timestamps, poses7)

    if args.benchmark_out:
        with open(args.benchmark_out, "w") as fh:
            for k, m in enumerate(tracker.metrics):
                inl = m.get("inliers", 0)
                err = m.get("chi2", 0.0)
                epi = err / inl if inl else 0.0
                if k > 0:
                    d = np.linalg.inv(traj[k - 1]) @ traj[k]
                    dist = float(np.linalg.norm(d[:3, 3]))
                    angle = float(np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)))
                else:
                    dist = angle = 0.0
                fh.write(
                    f"{inl} {err:.6f} {epi:.6f} {frame_times[k]:.6f} "
                    f"{dist:.6f} {angle:.6f} {m.get('fraction', 0.0):.6f} "
                    + " ".join(f"{v:.6f}" for v in poses7[k])
                    + "\n"
                )

    result = {
        "device": str(device),
        "frames": len(traj),
        "keyframes": tracker.n_keyframes,
        "trajectory": args.out,
        "mean_frame_time_s": float(np.mean(frame_times)),
        "frames_per_s": float(len(frame_times) / np.sum(frame_times)),
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
