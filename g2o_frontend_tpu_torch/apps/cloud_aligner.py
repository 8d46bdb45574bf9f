"""Pairwise cloud/depth alignment command line (counterpart of
``g2o_frontend_tpu/apps/cloud_aligner.py``, the pwn_cloud_aligner analog).

Aligns two depth images (16-bit TUM PNGs, .npy float meters, or reference
`.pwn` cloud files, re-rendered through the projector like the reference
app) and prints the transform and statistics as one JSON line. The JAX
app's ``--viz-prefix`` (matplotlib renderings) is not ported.

Usage:
  python -m g2o_frontend_tpu_torch.apps.cloud_aligner REF CUR [--device cuda]
      [--scale 2] [--fx 525 --fy 525 --cx 319.5 --cy 239.5]
      [--rows 480 --cols 640] [--outer-iterations 10]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..io.tum import load_depth_png
from ..pwn.aligner import AlignerConfig, align
from ..pwn.cloud_io import load_pwn
from ..pwn.converter import ConverterConfig, depth_to_cloud
from ..pwn.projector import PinholeProjector
from ..utils import lie


def _parser():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("reference")
    ap.add_argument("current")
    ap.add_argument("--device", default="cuda", help="torch device of the clouds and the alignment")
    ap.add_argument("--scale", type=int, default=1, help="integer image downscale")
    ap.add_argument("--fx", type=float, default=525.0)
    ap.add_argument("--fy", type=float, default=525.0)
    ap.add_argument("--cx", type=float, default=319.5)
    ap.add_argument("--cy", type=float, default=239.5)
    ap.add_argument("--outer-iterations", type=int, default=10)
    ap.add_argument("--rows", type=int, default=480, help="rows of a .pwn file's rendered depth")
    ap.add_argument("--cols", type=int, default=640, help="cols of a .pwn file's rendered depth")
    return ap


def _load_depth(path, args):
    """(H, W) float32 meters from a .npy, a 16-bit PNG or a .pwn cloud."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if not path.endswith(".pwn"):
        return load_depth_png(path)
    # host-side z-buffer render of the stored cloud (an IO path; the
    # reference app converts .pwn clouds through the projector the same way)
    p = load_pwn(path)["points"]
    u = np.round(p[:, 0] / np.maximum(p[:, 2], 1e-9) * args.fx + args.cx).astype(int)
    v = np.round(p[:, 1] / np.maximum(p[:, 2], 1e-9) * args.fy + args.cy).astype(int)
    z = p[:, 2]
    ok = (z > 0.1) & (u >= 0) & (u < args.cols) & (v >= 0) & (v < args.rows)
    img = np.zeros((args.rows, args.cols), np.float32)
    order = np.argsort(-z[ok])  # far to near: near wins
    img[v[ok][order], u[ok][order]] = z[ok][order]
    return img


def run(argv=None) -> dict:
    """Parse `argv`, align the pair; returns the result dict."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    s = args.scale
    d_ref = _load_depth(args.reference, args)[::s, ::s]
    d_cur = _load_depth(args.current, args)[::s, ::s]
    H, W = d_ref.shape
    proj = PinholeProjector(rows=H, cols=W, fx=args.fx / s, fy=args.fy / s, cx=args.cx / s, cy=args.cy / s,
                            min_distance=0.1, max_distance=10.0)
    ccfg = ConverterConfig(min_image_radius=max(2, 10 // s), max_image_radius=max(4, 30 // s),
                           min_points=max(10, 50 // (s * s)))
    ref, cur = (depth_to_cloud(torch.as_tensor(np.ascontiguousarray(d), device=device), proj, ccfg)
                for d in (d_ref, d_cur))
    res = align(ref, cur, proj, config=AlignerConfig(outer_iterations=args.outer_iterations))
    T = res.T.double().cpu().numpy()
    return {
        "device": str(device),
        "transform": T.tolist(),
        "t2v": lie.se3_t2v(res.T.float().cpu()).tolist(),
        "inliers": int(res.inliers),
        "chi2": float(res.chi2),
        "translational_ratio": float(res.translational_ratio),
        "rotational_ratio": float(res.rotational_ratio),
        "valid": bool(res.valid),
    }


def main(argv=None):
    print(json.dumps(run(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
