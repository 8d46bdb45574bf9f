"""What the PWN odometry drivers share: the sequence rendered from the
seed, the program's configuration objects and the reference's from the
same file, and the comparisons of one frame's outputs."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import depth as gen_depth
from ..reference import pwn as ref


def render(run):
    """The sequence's raw counts as host uint16 (frames, H, W), rendered
    on the device; the seconds it took go into the set-up's parts."""
    t = time.perf_counter()
    counts, _ = gen_depth.render_counts(run.config["sequence"], run.config["camera"], run.seed, run.device)
    host = counts.cpu().numpy().astype(np.uint16)
    del counts
    run.setup_parts["render"] = time.perf_counter() - t
    return host


def meters(run, counts):
    """Raw counts -> float32 meters on the host, as a TUM reader does."""
    return counts.astype(np.float32) * np.float32(1.0 / run.config["camera"]["depth_counts_per_m"])


def program_configs(run):
    """(projector, converter config, aligner config) of the program."""
    from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig
    from g2o_frontend_tpu_torch.pwn.converter import ConverterConfig
    from g2o_frontend_tpu_torch.pwn.projector import PinholeProjector

    cam, c, a = run.config["camera"], run.config["converter"], run.config["aligner"]
    proj = PinholeProjector(rows=cam["rows"], cols=cam["cols"], fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                            cy=cam["cy"], min_distance=cam["min_distance"], max_distance=cam["max_distance"])
    ccfg = ConverterConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in c.items()})
    return proj, ccfg, AlignerConfig(**a)


def pose_gap(A, B):
    """(translation distance, rotation angle) between two 4x4 poses."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    M = A[:3, :3].T @ B[:3, :3]
    sin = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    angle = np.arctan2(sin, (np.trace(M) - 1.0) / 2.0)  # exact near 0, where arccos is not
    return float(np.linalg.norm(A[:3, 3] - B[:3, 3])), float(angle)


def rel_gap(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


# How near a threshold of the keyframe policy the reference's inlier count
# may lie for rounding to tip the decision: a share of the count (the
# program's inlier counts part from the reference's by up to ~6e-4 of it).
DECISION_BAND = 2e-3


def near_decision(inliers, run, band):
    """True where the reference's inlier count lies within `band` of a
    threshold of the keyframe policy, so rounding may tip the decision."""
    cam, trk = run.config["camera"], run.config["tracker"]
    edges = (trk["new_frame_inliers_fraction"] * cam["rows"] * cam["cols"], trk["min_cloud_inliers"])
    return any(abs(inliers - e) <= band for e in edges)


def cloud_gap(prog, refc):
    """The share of pixels (valid on either side) at which the program's
    cloud departs from the reference's beyond float32 rounding: validity,
    point (1e-6 m), normal (1e-5), curvature (1e-5), the information
    matrices (1e-5 of the pixel's largest entry)."""
    valid = prog.valid | refc.valid
    bad = prog.valid != refc.valid
    bad |= ((prog.p - refc.p).abs() > 1e-6 * (1 + refc.p.abs())).any(0)
    bad |= ((prog.n - refc.n).abs() > 1e-5).any(0)
    bad |= (prog.curv - refc.curv).abs() > 1e-5
    for a, b in ((prog.op, refc.op), (prog.on, refc.on)):
        scale = b.abs().amax(0).clamp_min(1e-12)
        bad |= ((a - b).abs() > 1e-5 * scale).any(0)
    n = int(valid.sum())
    return float((bad & valid).sum()) / max(n, 1)


def ref_cloud(run, counts, precision="float32"):
    depth = torch.from_numpy(meters(run, counts)).to(run.device)
    return ref.convert(depth, run.config["camera"], run.config["converter"], precision)
