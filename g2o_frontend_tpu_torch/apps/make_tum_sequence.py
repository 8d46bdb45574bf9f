"""Write a TUM-format RGB-D sequence of the synthetic stress world
(counterpart of ``scripts/make_tum_sequence.py``).

Renders a Kinect-intrinsics 640x480 depth sequence over the stress run's
wandering loop (three laps with revisits, yaw sweeps and a vertical bob)
and writes a TUM directory:

  depth/<ts>.png     16-bit grayscale PNGs, 1/5000 m (TUM convention)
  depth.txt          timestamp -> path index
  groundtruth.txt    timestamp x y z qx qy qz qw

The bytes are those of the JAX package's script for the same ``--frames``.
Rendering is numpy; the ground-truth quaternions come from the float32
``lie.mat2quat_full`` on the CPU.

    python -m g2o_frontend_tpu_torch.apps.make_tum_sequence OUT_DIR --frames 120
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..io import tum
from ..io.image_codec import encode_image
from ..pwn.projector import PinholeProjector
from ..utils import lie
from ..utils.synth import render_planes_depth


def wander_pose(k, n_frames):
    """Frame k's camera pose on the stress run's wandering loop (3 laps)."""
    a = 2 * np.pi * (3.0 * k / n_frames)
    T = np.eye(4)
    T[:3, 3] = [0.55 * np.cos(a) + 0.05 * np.sin(5 * a), 0.06 * np.sin(2 * a), 0.3 * np.sin(a)]
    yaw = 0.3 * np.sin(a) + 0.08 * np.cos(3 * a)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return T


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--fps", type=float, default=30.0)
    args = ap.parse_args(argv)
    fx, fy, cx, cy = tum.kinect_presets["kinect"]
    proj = PinholeProjector(rows=480, cols=640, fx=fx, fy=fy, cx=cx, cy=cy, min_distance=0.3, max_distance=6.0)

    os.makedirs(os.path.join(args.out_dir, "depth"), exist_ok=True)
    depth_lines = ["# timestamp filename"]
    gt_lines = ["# timestamp tx ty tz qx qy qz qw"]
    for k in range(args.frames):
        ts = k / args.fps
        T = wander_pose(k, args.frames)
        depth = render_planes_depth(T, proj, device="cpu").numpy()
        d16 = np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)
        rel = f"depth/{ts:.6f}.png"
        with open(os.path.join(args.out_dir, rel), "wb") as fh:
            fh.write(encode_image(d16, "png"))
        depth_lines.append(f"{ts:.6f} {rel}")
        q = lie.mat2quat_full(torch.as_tensor(T[:3, :3], dtype=torch.float32)).numpy()
        gt_lines.append(f"{ts:.6f} " + " ".join(f"{v:.6f}" for v in [T[0, 3], T[1, 3], T[2, 3], q[1], q[2], q[3], q[0]]))
    with open(os.path.join(args.out_dir, "depth.txt"), "w") as fh:
        fh.write("\n".join(depth_lines) + "\n")
    with open(os.path.join(args.out_dir, "groundtruth.txt"), "w") as fh:
        fh.write("\n".join(gt_lines) + "\n")
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
