"""Benchmark harness (counterpart of the dataset-free sections of
``bench.py``). Prints one JSON line.

Headline: PWN dense aligner frames/s at the reference's compute envelope,
640x480 depth, 10 outer x 1 inner iterations, on the exact gather
association that kernel 1 (``csrc/fused_aligner.cu``) computes on the card.
``vs_baseline`` is that rate over the same workload's on the host CPU
(``--no-cpu-control`` skips the CPU run and reports 1.0).

Consistency is asserted, not assumed: the end-to-end tracker frames/s must
be strictly below the bare aligner's (each tracker frame is a full align
plus a depth->cloud conversion), the aligner must recover the pair's known
motion within 1 cm, and the 8-shard SE3 SPIKE solve must reach 1.01x its
float64 control. Every timed chain consumes all outputs through its carry,
and each measurement ends in ``torch.cuda.synchronize()``; a rate is the
slope between the least times of two chain lengths over a few turns,
which cancels the constant costs and leaves out the host's passing load.
Python's garbage collector stays on, as in a user's process: its passes
are part of the host-bound rates on the card. One full collection before
the timed turns empties its young generations, and the aligner, the
converter and the tracker are timed in turns, so that the rates the
asserts compare share the host's state. On the card every stage
replays its CUDA graph (``utils/graphs``); each key is captured in the
warm-up calls of its chain, outside the timed turns.

    python -m g2o_frontend_tpu_torch.apps.bench
    python -m g2o_frontend_tpu_torch.apps.bench --device cpu --no-cpu-control
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import time

import numpy as np
import torch

from ..utils.synth import bench_pair


def _wait(x):
    """Wait for the device to finish the work behind tensor `x`."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x


def _slopes(chains, tries):
    """Seconds a step of each chain of `chains` ({name: (fn, lo, hi)}):
    (min t_hi - min t_lo) / (hi - lo), the least time of each chain length
    over `tries` turns, with the spread of the turns' own slopes over it.
    Every chain length is warmed first; the chains are timed in turns.

    A shared host's load only adds time, and it drifts from turn to turn by
    more than the tracker's rate lies below the aligner's, so medians of
    the turns' slopes could put the two in the wrong order. The least time
    leaves such load out; the collector's passes, which every run of a
    chain makes, stay in."""
    for fn, lo, hi in chains.values():
        _wait(fn(lo))
        _wait(fn(hi))
    times = {name: [] for name in chains}
    gc.collect()
    for _ in range(tries):
        for name, (fn, lo, hi) in chains.items():
            t0 = time.perf_counter()
            _wait(fn(lo))
            t1 = time.perf_counter()
            _wait(fn(hi))
            t2 = time.perf_counter()
            times[name].append((t1 - t0, t2 - t1))
    out = {}
    for name, (_, lo, hi) in chains.items():
        t_lo, t_hi = np.array(times[name]).T
        step = float(t_hi.min() - t_lo.min()) / (hi - lo)
        slopes = (t_hi - t_lo) / (hi - lo)
        out[name] = (step, float(slopes.max() - slopes.min()) / step)
    return out


def _aligner_chains(device, H, W, reps):
    """The aligner's and the converter's chains on the bench pair, and the
    aligner's accuracy on it."""
    from ..pwn.aligner import AlignerConfig, align
    from ..pwn.converter import ConverterConfig, depth_to_cloud

    d_ref, d_cur, proj, T_gt = bench_pair(device, H, W)
    if H >= 240:
        ccfg = ConverterConfig()
    else:  # the reference's scale-4 stats radii (conf pwn_slam_catacombs_gui.conf)
        ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    acfg = AlignerConfig(outer_iterations=10, inner_iterations=1)

    ref = depth_to_cloud(d_ref, proj, ccfg)
    cur = depth_to_cloud(d_cur, proj, ccfg)
    res = align(ref, cur, proj, config=acfg)
    err = np.linalg.inv(T_gt) @ res.T.cpu().double().numpy()

    def align_chain(n):
        # every statistic feeds the carry, so no output goes unused
        T = torch.eye(4, dtype=ref.p.dtype, device=ref.p.device)
        for _ in range(n):
            r = align(ref, cur, proj, T, acfg)
            stats = (r.omega.sum() + r.chi2 + r.inliers + r.translational_ratio + r.rotational_ratio
                     + r.mean.sum())
            T = r.T + (1e-30 * stats).to(r.T.dtype)
        return T

    def convert_chain(n):
        carry = torch.zeros((), dtype=torch.float32, device=d_cur.device)
        for _ in range(n):
            c = depth_to_cloud(d_cur + 1e-30 * carry, proj, ccfg)
            carry = sum(leaf.sum() for leaf in c)
        return carry

    chains = {"align": (align_chain, 2, 2 + 4 * reps), "convert": (convert_chain, 5, 5 + 24 * reps)}
    return chains, {"t_err_m": float(np.linalg.norm(err[:3, 3])), "inliers": int(res.inliers)}


def bench_pwn_aligner(device="cuda", H=480, W=640, reps=5):
    """align frames/s (chained aligns, each warm-started from the previous
    T), depth_to_cloud frames/s, and the accuracy on the pair."""
    chains, accuracy = _aligner_chains(device, H, W, reps)
    s = _slopes(chains, tries=3)
    return {"align_fps": 1.0 / s["align"][0], "convert_fps": 1.0 / s["convert"][0], **accuracy}


def _tracker_chain(device, H, W, lo, hi):
    """The tracker's chain: `odometry_scan` over n frames of the bench
    pair's reference depth, scaled a little each frame."""
    from ..pwn.aligner import AlignerConfig
    from ..pwn.converter import ConverterConfig
    from ..slam.pwn_tracker import odometry_scan

    d_ref, _, proj, _ = bench_pair(device, H, W)
    ccfg = ConverterConfig()
    acfg = AlignerConfig(outer_iterations=10)
    base = d_ref.cpu().numpy()
    seqs = {n: torch.as_tensor(np.stack([base * (1.0 + 0.002 * (k % 5)) for k in range(n)]), dtype=torch.float32,
                               device=device) for n in (lo, hi)}

    def chain(n):
        traj, m = odometry_scan(seqs[n], proj, ccfg, acfg, device=device)
        # every output is consumed, the omega / eigenratio statistics too
        return traj.sum() + m["inliers"].sum() + m["fraction"].sum() + m["omega_trace"].sum()

    return {"tracker": (chain, lo, hi)}


def bench_tracker(H=480, W=640, lo=4, hi=44, device="cuda"):
    """End-to-end odometry frames/s: depth->cloud, a 10-outer align and the
    keyframe policy a frame, through `odometry_scan` (no host sync a
    frame)."""
    dt, spread = _slopes(_tracker_chain(device, H, W, lo, hi), tries=5)["tracker"]
    return {"tracker_fps": 1.0 / dt, "tracker_dt_spread": spread}


def bench_align_and_tracker(device="cuda", H=480, W=640, reps=5, lo=4, hi=44, tries=7):
    """`bench_pwn_aligner` and `bench_tracker` timed in turns, so that the
    aligner's and the tracker's rates share the host's state."""
    chains, accuracy = _aligner_chains(device, H, W, reps)
    s = _slopes({**chains, **_tracker_chain(device, H, W, lo, hi)}, tries)
    return {"align_fps": 1.0 / s["align"][0], "convert_fps": 1.0 / s["convert"][0], **accuracy,
            "align_dt_spread": s["align"][1], "tracker_fps": 1.0 / s["tracker"][0],
            "tracker_dt_spread": s["tracker"][1]}


# the 300-pose multi-loop SE3 world of bench.py:363-365, its optimum not zero
SE3_SIM_WORLD = dict(n_poses=300, seed=0, world_size=20.0, closure_min_gap=50, closure_radius=3.5,
                     closure_prob=0.9)


def bench_se3_sim_distributed(n_dev=8, device="cuda"):
    """The partitioned SE3 SPIKE solve on `n_dev` shards stacked on
    `device`, against the float64 control."""
    from ..parallel.mesh import StackedMesh
    from ..parallel.partitioned_pose_graph import optimize_se3_partitioned
    from ..slam.simulator import Simulator3DConfig, simulate_se3
    from ..solvers.control import control_optimize_se3

    g, info = simulate_se3(Simulator3DConfig(**SE3_SIM_WORLD), device=device)
    ctl = control_optimize_se3(g.to("cpu"), max_iters=60)
    _, tr = optimize_se3_partitioned(g, StackedMesh(n_dev, device), iters=25, cg_iters=100, precond="spike")
    return {"chi2": float(tr[-1]), "chi2_control": float(ctl["chi2"]), "n_closures": info["n_closures"]}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device of the benchmark")
    ap.add_argument("--no-cpu-control", action="store_true", help="skip the CPU run of the aligner (vs_baseline 1.0)")
    return ap


def run(argv=None) -> dict:
    """Run every section, hold the consistency asserts; returns the JSON
    line's dict."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    pwn = trk = bench_align_and_tracker(device)
    pwn4 = bench_pwn_aligner(device, H=120, W=160, reps=10)
    dse3 = bench_se3_sim_distributed(8, device)

    # the end-to-end tracker cannot beat the bare aligner: each tracker
    # frame is a full align plus a depth->cloud conversion. Strict.
    if not trk["tracker_fps"] < pwn["align_fps"]:
        raise AssertionError(f"impossible: tracker_fps {trk['tracker_fps']:.1f} >= align_fps {pwn['align_fps']:.1f} "
                             f"(spread {trk['tracker_dt_spread']:.3f}): the timing harness is broken")
    if not pwn["t_err_m"] < 0.01:
        raise AssertionError(f"aligner accuracy broke: {pwn['t_err_m']}")
    if not (math.isfinite(dse3["chi2"]) and dse3["chi2"] <= 1.01 * dse3["chi2_control"]):
        raise AssertionError(f"distributed SE3 above 1.01x its control: {dse3}")

    vs = 1.0
    if not args.no_cpu_control:
        vs = pwn["align_fps"] / bench_pwn_aligner("cpu", reps=2)["align_fps"]
    return {
        "metric": "pwn_align_fps_640x480_10outer",
        "value": pwn["align_fps"],
        "unit": "aligner frames/s (640x480, 10 outer x 1 inner, ref envelope, exact gather association)",
        "vs_baseline": vs,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "align_fps_scale4": pwn4["align_fps"],
        "convert_fps": pwn["convert_fps"],
        "tracker_fps_e2e": trk["tracker_fps"],
        "tracker_dt_spread": trk["tracker_dt_spread"],
        "align_dt_spread": pwn["align_dt_spread"],
        "align_t_err_m": pwn["t_err_m"],
        "align_inliers": pwn["inliers"],
        "se3_sim_chi2_distributed_8dev": dse3["chi2"],
        "se3_sim_chi2_control": dse3["chi2_control"],
    }


def main(argv=None):
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    main()
