"""Run the keyframe tracker over one sequence on two devices in lockstep and
report where the two runs part.

Both trackers get the same depth image each frame. The report gives, per
frame, each run's keyframe decision, inliers and inlier fraction and the
distance between the two poses; then, at the first frame whose keyframe
decisions differ (or, failing that, the first whose poses part by more
than `--pose-tol`), each run's alignment of that frame: its inliers, its
fraction against the keyframe threshold, its chi2 and the translational
and rotational eigenvalue ratios of its information matrix. The same frame
is then aligned once more on both devices from the first run's inputs (its
keyframe depth and its initial guess), to tell the arithmetic of the two
devices from the histories of the two runs.

Usage:
  python -m g2o_frontend_tpu_torch.apps.tracker_parity SEQ_DIR --conf FILE
      [--device cuda] [--against cpu] [--max-frames N] [--pose-tol 1e-3]
      [--out report.json]

Prints the parting frame's summary as one JSON line; `--out` also gets the
per-frame table.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..io import tum
from ..pwn.aligner import align
from ..pwn.converter import depth_to_cloud
from ..pwn.pipeline import load_pipeline
from ..slam.pwn_tracker import PwnTracker, PwnTrackerConfig


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("seq_dir", help="TUM sequence directory")
    ap.add_argument("--conf", required=True, help="reference-format boss pipeline conf")
    ap.add_argument("--device", default="cuda", help="torch device of the first run")
    ap.add_argument("--against", default="cpu", help="torch device of the second run")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--pose-tol", type=float, default=1e-3, help="translation (m) at which two poses part")
    ap.add_argument("--out", help="JSON file for the whole report")
    return ap


def _state(t: PwnTracker):
    return t.prev_kf_key, t.prev_kf_T.copy(), t.global_T.copy()


def _alignment(tracker: PwnTracker, state, depth, device):
    """The tracker's alignment of `depth` from `state` (its keyframe key,
    keyframe pose and pose before the frame), recomputed on `device`."""
    key, kf_T, glob_T = state
    ref = depth_to_cloud(torch.as_tensor(tracker.cache._depths[key]).to(device), tracker.projector, tracker.ccfg)
    cur = depth_to_cloud(torch.as_tensor(depth, dtype=torch.float32, device=device), tracker.projector,
                         tracker.ccfg)
    guess = (np.linalg.inv(kf_T) @ glob_T).astype(np.float32)
    res = align(ref, cur, tracker.projector, guess, tracker.acfg)
    n = tracker.projector.rows * tracker.projector.cols
    return {
        "device": str(device),
        "inliers": int(res.inliers),
        "fraction": int(res.inliers) / n,
        "chi2": float(res.chi2),
        "translational_ratio": float(res.translational_ratio),
        "rotational_ratio": float(res.rotational_ratio),
        "t": res.T[:3, 3].cpu().double().tolist(),
    }


def _angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def run(argv=None) -> dict:
    args = _parser().parse_args(argv)
    devices = [args.device, args.against]
    pipe = load_pipeline(args.conf)
    proj, ccfg, acfg, scale = pipe.scaled_projector(), pipe.converter_config, pipe.aligner_config, pipe.scale
    kf_fraction = pipe.tracker_config.new_frame_inliers_fraction if pipe.tracker_config else 0.4
    min_inliers = max(50, int(3000 * (proj.rows * proj.cols) / (480 * 640)))
    trackers = [PwnTracker(proj, ccfg, acfg, PwnTrackerConfig(new_frame_inliers_fraction=kf_fraction,
                                                               min_cloud_inliers=min_inliers), device=d)
                for d in devices]
    index = tum.read_depth_index(args.seq_dir)
    if args.max_frames:
        index = index[: args.max_frames]

    frames, parting, states, depths = [], None, [], []
    for k, (_, rel) in enumerate(index):
        raw = tum.load_depth_png_raw(os.path.join(args.seq_dir, rel))[::scale, ::scale]
        depth = raw.astype(np.float32) * np.float32(1.0 / 5000.0)
        states.append([_state(t) for t in trackers])
        depths.append(depth)
        ms = [t.process_frame(depth) for t in trackers]
        Ta, Tb = (t.global_T for t in trackers)
        row = {
            "frame": k,
            "keyframe": [m["keyframe"] for m in ms],
            "inliers": [m["inliers"] for m in ms],
            "fraction": [m["fraction"] for m in ms],
            "dt": float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
            "drot": _angle(Ta[:3, :3], Tb[:3, :3]),
        }
        frames.append(row)
        if parting is None and row["keyframe"][0] != row["keyframe"][1]:
            parting = k
    first_inliers = next((r["frame"] for r in frames if r["inliers"][0] != r["inliers"][1]), None)
    first_pose = next((r["frame"] for r in frames[1:] if r["dt"] > args.pose_tol), None)
    report = {
        "devices": devices,
        "frames": len(frames),
        "keyframes": [t.n_keyframes for t in trackers],
        "kf_fraction": kf_fraction,
        "first_inliers_differ": first_inliers,
        "first_keyframe_differs": parting,
        "first_pose_parts": first_pose,
        "final_dt": frames[-1]["dt"],
    }
    at = parting if parting is not None else first_pose
    if at is not None:
        report["at"] = at
        report["row"] = frames[at]
        report["previous_row"] = frames[at - 1]
        # each run's alignment of the frame, from its own history
        report["own"] = [_alignment(t, s, depths[at], t.device) for t, s in zip(trackers, states[at])]
        # the first run's inputs on both devices
        report["same_inputs"] = [_alignment(trackers[0], states[at][0], depths[at], torch.device(d))
                                 for d in devices]
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({**report, "per_frame": frames}, fh, indent=1)
    return report


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
