"""The live Kinect user: one sensor, closed loop. Each frame's raw counts
become float32 meters on the host and go to `PwnTracker.process_frame`,
as the odometry command line does without ``--scan``; the sequence's
frames are cycled for the whole window (its path is periodic).

Traffic parameters: ``warm_frames`` (a throw-away tracker's frames in
set-up, which capture the converter's and the aligner's graphs),
``judge_frames`` (frames drawn from the seed for the judge),
``judge_clouds`` (cached keyframe clouds compared), ``trace_seconds``.

The judge follows the tracker step by step from its own state: for a
drawn frame k it takes the last keyframe before k and the pose of frame
k-1 from the tracker's trajectory, converts both depths and aligns them
with the plain reference (`reference/pwn.py`, float32), applies the
tracker's rules and compares:

- ``t_gap_m``, ``r_gap_rad``: frame k's global pose;
- ``inlier_gap``, ``chi2_gap``: the alignment's inliers and chi2, relative;
- ``omega_gap``: a keyframe relation's information, relative (Frobenius);
- ``keyframe_flips``: keyframe decisions that differ where the
  reference's inlier count is not within `_pwn.DECISION_BAND` of a
  threshold (exact: 0); frame 0 must be a keyframe at the identity;
- ``cloud_gap``: cached keyframe clouds against the reference converter,
  the share of pixels that depart beyond rounding.

Each gap is read as its largest over the drawn frames and as its 90th
percentile (``<name>_p90``); the limits file says which are compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference import pwn as ref
from ..reference.precision import no_tf32
from . import _pwn


class State:
    pass


def _tracker(run, st):
    from g2o_frontend_tpu_torch.slam.pwn_tracker import PwnTracker, PwnTrackerConfig

    return PwnTracker(st.proj, st.ccfg, st.acfg, PwnTrackerConfig(**run.config["tracker"]), device=run.device)


def setup(run):
    t = time.perf_counter()
    from g2o_frontend_tpu_torch.slam import pwn_tracker

    st = State()
    st.module = pwn_tracker
    st.proj, st.ccfg, st.acfg = _pwn.program_configs(run)
    run.setup_parts["import"] = time.perf_counter() - t
    st.counts = _pwn.render(run)
    t = time.perf_counter()
    warm = _tracker(run, st)
    for i in range(int(run.traffic["warm_frames"])):
        warm.process_frame(_pwn.meters(run, st.counts[i]))
    del warm
    run.setup_parts["warm_up"] = time.perf_counter() - t
    st.tracker = _tracker(run, st)
    return st


def window(run, st, seconds):
    tracker, counts = st.tracker, st.counts
    frame_s = []
    t0 = time.perf_counter()
    i = 0
    while not frame_s or time.perf_counter() - t0 - run.traced_seconds() < seconds:
        depth = _pwn.meters(run, counts[i % len(counts)])
        s0 = time.perf_counter()
        tracker.process_frame(depth)
        frame_s.append(time.perf_counter() - s0)
        i += 1
        run.poll(time.perf_counter() - t0)
    total = time.perf_counter() - t0
    run.counters.update(frames=len(frame_s), keyframes=tracker.n_keyframes,
                        frame_ms_quartiles=[1e3 * harness.percentile(frame_s, q) for q in (25, 50, 75, 95, 99)])
    return harness.Window(len(frame_s), 0, {"frames_per_s": len(frame_s) / total,
                                           "frame_ms_p95": 1e3 * harness.percentile(frame_s, 95)})


def control(run, st, precision="tf32"):
    """Put the reference, computed in `precision`, in the converter's and
    the aligner's place (the control of `correct`); returns the function
    that puts the program back."""
    cam, c, a = run.config["camera"], run.config["converter"], run.config["aligner"]
    mod = st.module
    saved = mod.depth_to_cloud, mod.align
    mod.depth_to_cloud = lambda depth, projector, config: ref.convert(depth, cam, c, precision)
    mod.align = lambda r, cur, projector, guess, config: ref.align(r, cur, cam, guess, a, precision)

    def undo():
        mod.depth_to_cloud, mod.align = saved

    return undo


def judge(run, st):
    tr = st.tracker
    n = len(tr.metrics)
    metrics = list(tr.metrics)
    traj = np.stack(tr.trajectory)
    info = {r.node_to.payload["frame"]: np.asarray(r.information) for r in tr.manager.relations}
    kf = [bool(m["keyframe"]) for m in metrics]
    kf_idx = [k for k in range(n) if kf[k]]
    rng = np.random.default_rng([run.seed, 2])
    sample = sorted(int(k) for k in rng.choice(np.arange(1, n), size=min(int(run.traffic["judge_frames"]), n - 1),
                                               replace=False)) if n > 1 else []
    recent = kf_idx[-int(run.traffic["judge_clouds"]) - 1:-1]  # reference clouds of frames the tracker aligned to
    prog_clouds = {k: tr.cache.get(k) for k in recent}
    del st.tracker, tr
    if run.device != "cpu":
        torch.cuda.empty_cache()
    no_tf32()

    cam, acfg, tcfg = run.config["camera"], run.config["aligner"], run.config["tracker"]
    pixels = cam["rows"] * cam["cols"]
    clouds = {}

    def cloud(k):
        if k not in clouds:
            clouds[k] = _pwn.ref_cloud(run, st.counts[k % len(st.counts)])
        return clouds[k]

    vals = {"t_gap_m": [], "r_gap_rad": [], "inlier_gap": [], "chi2_gap": [], "omega_gap": [], "cloud_gap": []}
    flips = 0.0 if kf[0] and np.array_equal(traj[0], np.eye(4)) else 1.0
    for k in sample:
        j = max(i for i in kf_idx if i < k)
        guess = np.linalg.inv(traj[j]) @ traj[k - 1]
        res = ref.align(cloud(j), cloud(k), cam, guess.astype(np.float32), acfg)
        inl = int(res.inliers)
        fallback = inl < max(1, tcfg["min_cloud_inliers"])
        g = traj[k - 1] @ guess if fallback else traj[j] @ res.T.double().cpu().numpy()
        if (k + 1) % tcfg["renormalize_every"] == 0:
            g = ref.renormalize(g)
        t_gap, r_gap = _pwn.pose_gap(traj[k], g)
        vals["t_gap_m"].append(t_gap)
        vals["r_gap_rad"].append(r_gap)
        vals["inlier_gap"].append(abs(metrics[k]["inliers"] - inl) / max(inl, 1))
        vals["chi2_gap"].append(_pwn.rel_gap(metrics[k]["chi2"], res.chi2))
        kf_ref = fallback or inl / pixels < tcfg["new_frame_inliers_fraction"]
        if kf_ref != kf[k] and not _pwn.near_decision(inl, run, _pwn.DECISION_BAND * inl + 1):
            flips += 1
        if kf[k] and kf_ref and not fallback and k in info:
            want = ref.relation_information(res.omega.double().cpu().numpy())
            vals["omega_gap"].append(float(np.linalg.norm(info[k] - want) / max(np.linalg.norm(want), 1e-12)))
    vals["keyframe_flips"] = [flips]
    for k, prog in prog_clouds.items():
        vals["cloud_gap"].append(_pwn.cloud_gap(prog, cloud(k)))
    run.say("judge", f"{len(sample)} of {n} frames against the reference, {len(prog_clouds)} keyframe clouds")
    return harness.checks_from(run, harness.summarise(vals))
