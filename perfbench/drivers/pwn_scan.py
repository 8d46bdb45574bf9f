"""Offline evaluation of recorded sequences: each call hands a whole
sequence, as one raw uint16 stack with its meters per count, to
`slam.pwn_tracker.odometry_scan`, as the odometry command line does with
``--scan``, and reads the trajectory back (one sync a sequence). Calls
follow each other for the window (a closed loop).

Traffic parameters: ``rotations``, how many copies of the sequence are
kept, each starting at another frame (the path is periodic), so that
successive calls differ; ``warm_calls``, the whole-sequence calls of
set-up, which capture the converter's and the step's graphs and let the
memory allocator reach the window's sizes (a first call at full size ran
0.2-0.6 s slower than the later ones); ``judge_frames``
(frames drawn from the seed over all calls); ``judge_clouds`` (the last
calls whose final reference cloud is compared); ``trace_seconds``.

The judge follows each drawn frame from the scan's own state (the last
keyframe's pose and the previous frame's pose from its trajectory) with
the plain reference (`reference/pwn.py`, float32) and the scan's
keyframe rules, and compares ``t_gap_m``, ``r_gap_rad`` (the frame's
pose), ``inlier_gap``, ``omega_trace_gap`` (relative) and
``keyframe_flips`` (exact, outside `_pwn.DECISION_BAND` about a
threshold; frame 0 a keyframe at the identity). Each gap is read as its
largest over the drawn frames and as its 90th percentile
(``<name>_p90``); the limits file says which are compared. ``cloud_gap``: the converter's cloud that the scan carries out
of a call as its reference (the call's last keyframe's), against the
reference converter's of that frame, the share of pixels that depart
beyond rounding; the scan's stage is wrapped to keep that carry.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from ..reference import pwn as ref
from ..reference.precision import dtype, no_tf32
from . import _pwn


class State:
    pass


def setup(run):
    t = time.perf_counter()
    from g2o_frontend_tpu_torch.slam import pwn_tracker

    st = State()
    st.module = pwn_tracker
    st.proj, st.ccfg, st.acfg = _pwn.program_configs(run)
    run.setup_parts["import"] = time.perf_counter() - t
    counts = _pwn.render(run)
    t = time.perf_counter()
    n = len(counts)
    st.offsets = [k * n // int(run.traffic["rotations"]) for k in range(int(run.traffic["rotations"]))]
    st.stacks = [np.ascontiguousarray(np.roll(counts, -o, 0)) for o in st.offsets]
    run.setup_parts["stacks"] = time.perf_counter() - t
    st.scan = pwn_tracker.odometry_scan
    st.last_ref = [None]  # the reference cloud that the last call carried out
    stage = pwn_tracker._SCAN_STEP

    def scan_keeping_carry(*args, **kwargs):
        carry, outs = type(stage).scan(stage, *args, **kwargs)
        st.last_ref[0] = carry[0]
        return carry, outs

    stage.scan = scan_keeping_carry
    st.unwrap = lambda: delattr(stage, "scan")
    t = time.perf_counter()
    for stack in st.stacks[: int(run.traffic["warm_calls"])]:
        traj, _ = _call(run, st, stack)
        traj.cpu()
    run.setup_parts["warm_up"] = time.perf_counter() - t
    return st


def _call(run, st, stack):
    trk = run.config["tracker"]
    return st.scan(stack, st.proj, st.ccfg, st.acfg, kf_fraction=trk["new_frame_inliers_fraction"],
                   min_cloud_inliers=trk["min_cloud_inliers"],
                   depth_scale=1.0 / run.config["camera"]["depth_counts_per_m"], device=run.device)


def window(run, st, seconds):
    outs, frames, call_s, carried = [], 0, [], []
    t0 = time.perf_counter()
    while not outs or time.perf_counter() - t0 - run.traced_seconds() < seconds:
        c = len(outs) % len(st.stacks)
        s0 = time.perf_counter()
        traj, metrics = _call(run, st, st.stacks[c])
        traj = traj.cpu()  # the user's trajectory, on the host: the sequence's one sync
        outs.append((st.offsets[c], traj, metrics))
        carried.append((len(outs) - 1, st.last_ref[0]))
        del carried[: -int(run.traffic["judge_clouds"])]
        st.last_ref[0] = None
        call_s.append(time.perf_counter() - s0)
        frames += len(traj)
        run.poll(time.perf_counter() - t0)
    total = time.perf_counter() - t0
    st.outputs, st.carried = outs, [(c, ref_cloud) for c, ref_cloud in carried if ref_cloud is not None]
    run.counters.update(frames=frames, sequences=len(outs), call_s=call_s)
    return harness.Window(len(outs), 0, {"frames_per_s": frames / total})


def reference_scan(run, stack, precision, last_ref=None):
    """`odometry_scan`'s semantics with the plain reference in
    `precision`: (trajectory (K, 4, 4), metrics of (K,) tensors); the
    reference cloud it ends with goes into `last_ref`[0]."""
    cam, acfg, trk = run.config["camera"], run.config["aligner"], run.config["tracker"]
    dt = dtype(precision)
    ref_cloud = _pwn.ref_cloud(run, stack[0], precision)
    eye = torch.eye(4, dtype=dt, device=run.device)
    kf_T, g = eye, eye
    traj, cols = [eye], {"inliers": [0], "fraction": [1.0], "keyframe": [True], "omega_trace": [0.0]}
    for counts in stack[1:]:
        cur = _pwn.ref_cloud(run, counts, precision)
        guess = torch.linalg.solve(kf_T, g)
        res = ref.align(ref_cloud, cur, cam, guess, acfg, precision)
        ok = int(res.inliers) >= max(1, trk["min_cloud_inliers"])
        g = kf_T @ res.T if ok else g @ guess
        frac = int(res.inliers) / (cam["rows"] * cam["cols"])
        new_kf = frac < trk["new_frame_inliers_fraction"] or not ok
        if new_kf:
            ref_cloud, kf_T = cur, g
        traj.append(g)
        cols["inliers"].append(int(res.inliers))
        cols["fraction"].append(frac)
        cols["keyframe"].append(new_kf)
        cols["omega_trace"].append(float(torch.trace(res.omega) + res.translational_ratio + res.rotational_ratio))
    if last_ref is not None:
        last_ref[0] = ref_cloud
    return torch.stack(traj), {k: torch.tensor(v) for k, v in cols.items()}


def control(run, st, precision="tf32"):
    """Put the reference scan, computed in `precision`, in the program's
    place (the control of `correct`); returns the function that puts the
    program back."""
    program = st.scan
    st.scan = lambda stack, *args, **kwargs: reference_scan(run, stack, precision, st.last_ref)

    def undo():
        st.scan = program

    return undo


def judge(run, st):
    outs = [(o, traj.double().numpy(), {k: v.cpu().numpy() for k, v in m.items()}) for o, traj, m in st.outputs]
    stacks = st.stacks[0]
    carried = st.carried
    st.unwrap()
    del st.outputs, st.stacks, st.carried
    if run.device != "cpu":
        torch.cuda.empty_cache()
    no_tf32()
    cam, acfg, trk = run.config["camera"], run.config["aligner"], run.config["tracker"]
    n = len(stacks)
    pixels = cam["rows"] * cam["cols"]
    rng = np.random.default_rng([run.seed, 3])
    pairs = [(c, k) for c in range(len(outs)) for k in range(1, len(outs[c][1]))]
    pick = rng.choice(len(pairs), size=min(int(run.traffic["judge_frames"]), len(pairs)), replace=False)
    clouds = {}

    def cloud(i):
        if i not in clouds:
            clouds[i] = _pwn.ref_cloud(run, stacks[i % n])
        return clouds[i]

    flips = 0.0
    for _, traj, m in outs:
        if not (m["keyframe"][0] and np.array_equal(traj[0], np.eye(4))):
            flips += 1
    vals = {"t_gap_m": [], "r_gap_rad": [], "inlier_gap": [], "omega_trace_gap": []}
    for c, k in sorted(pairs[i] for i in pick):
        off, traj, m = outs[c]
        j = max(i for i in range(k) if m["keyframe"][i])
        guess = np.linalg.inv(traj[j]) @ traj[k - 1]
        res = ref.align(cloud(off + j), cloud(off + k), cam, guess.astype(np.float32), acfg)
        inl = int(res.inliers)
        ok = inl >= max(1, trk["min_cloud_inliers"])
        g = traj[j] @ res.T.double().cpu().numpy() if ok else traj[k - 1] @ guess
        t_gap, r_gap = _pwn.pose_gap(traj[k], g)
        vals["t_gap_m"].append(t_gap)
        vals["r_gap_rad"].append(r_gap)
        vals["inlier_gap"].append(abs(int(m["inliers"][k]) - inl) / max(inl, 1))
        omega_tr = float(torch.trace(res.omega) + res.translational_ratio + res.rotational_ratio)
        vals["omega_trace_gap"].append(_pwn.rel_gap(m["omega_trace"][k], omega_tr))
        kf_ref = inl / pixels < trk["new_frame_inliers_fraction"] or not ok
        if kf_ref != bool(m["keyframe"][k]) and not _pwn.near_decision(inl, run, _pwn.DECISION_BAND * inl + 1):
            flips += 1
    vals["keyframe_flips"] = [flips]
    vals["cloud_gap"] = []
    for c, prog in carried:
        off, _, m = outs[c]
        last_kf = max(i for i in range(len(m["keyframe"])) if m["keyframe"][i])
        vals["cloud_gap"].append(_pwn.cloud_gap(prog, cloud(off + last_kf)))
    run.say("judge", f"{len(pick)} frames of {len(outs)} sequences against the reference, "
            f"{len(carried)} carried clouds")
    return harness.checks_from(run, harness.summarise(vals))
