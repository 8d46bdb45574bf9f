"""The Kinect user with SLAM on: one sensor, closed loop, through
`PwnSlam.process_frame` (tracking, loop closing with consensus, the
hierarchical map solve), as ``apps/pwn_slam`` runs a sequence.

Set-up renders the sequence, tracks `prime_frames` (one lap of the
periodic path) into the `PwnSlam` that the window continues, so that the
window starts with a mapped lap to close against, captures ahead of time
(`PwnSlam.warm_up`) every `align_batch` bucket in `buckets` and every
map-solve capacity that `max_window_keyframes` more keyframes and
`max_window_closures` more accepted closures can reach, and attaches a
`SlamRecord` for the judge. The window then feeds the frames from
`prime_frames` on, each frame's counts made meters on the host as the live
cell does, until its seconds have run out or frame `last_frame` (the end
of the second lap) has been fed, whichever comes first: every window, the
traced one too, sees the same map (the first lap's and a part of the
second's) and the same batches (the second lap against the first). The
final solve is not run. The window's `counters` hold its frames,
keyframes, batches, the histogram of the batches' real and padded K, the
closures committed and rejected, the map solves, the cache's recomputes,
and the graphs captured inside the window (`window_captures`, 0 when
set-up captured all, and `window_captured`, what they were).

Traffic parameters: ``prime_frames``, ``last_frame``, ``buckets``,
``max_window_keyframes``, ``max_window_closures``, ``judge_frames``
(tracked frames drawn for the judge), ``judge_batches`` (closer batches,
and consensus calls, drawn), ``judge_candidates`` (candidates drawn in
each batch), ``judge_solves`` (map solves drawn besides the last),
``trace_seconds``.

The judge follows the program's own record (`PwnSlam.record`) of the
window and compares, each against the plain reference
(`reference/pwn.py`, `reference/pwn_slam.py`; float32, TF32 off, the map
solve in float64):

- ``t_gap_m``, ``r_gap_rad``, ``inlier_gap``, ``keyframe_flips``: a drawn
  frame aligned by the reference from the keyframe and poses the tracker
  aligned it from, its rules applied, as the live cell judges it;
- ``gate_flips``: drawn candidates of drawn batches, each matched by the
  reference from the recorded guess on the reference's clouds of the two
  frames, whose gate decision differs from the reference's where no gate
  quantity lies within `GATE_BAND` of its threshold, and where the
  reference in float64 decides as the float32 reference does, also outside
  the band (exact: 0). A candidate that its iterations do not settle ends
  where rounding takes it: the two references then part (one in 1,107
  candidates of a window on the card read float32 0.57 m from float64 and
  the port 0.79 m), and it counts under ``gate_unsettled``, printed;
  ``closure_t_gap_m``, ``closure_r_gap_rad``, ``closure_inlier_gap``,
  ``image_inlier_gap``: of those that both passed (the closures whose
  transform becomes a relation; a rejected candidate's alignment, from a
  poor overlap, may wander with rounding), the transform, the aligner's
  inliers and the image inliers (relative);
  ``closure_overlap_gap``: of every drawn candidate, the image inliers the
  program recorded against the reference's overlap at the program's own
  recorded transform (relative): a transform that is not the one its
  statistics were taken at;
- ``consensus_flips``: decisions of a drawn consensus that differ from the
  reference consensus on the recorded relations and counters (exact: 0);
- ``map_chi2_gap``, ``map_position_gap_m``: `judge_solves` map solves
  drawn from the window's and its last, each the fine (level-0) pass of a
  hierarchical solve, held to the float64 reference's solve of the same
  graph from the same poses at the same budget (`reference/pwn_slam.lm_se3`:
  the same LM iterations and CG steps): the two results' chi2 apart,
  relative to the reference's, or to one unit a relation where the
  reference's lies below that, and the largest distance between a node's
  two positions;
- ``no_closure``: 1 if the window committed no closure (limit 0).

Each gap is read as its largest and as its 90th percentile
(``<name>_p90``); the limits file says which are compared. The judge
prints the readings that it does not compare.

`control` puts the plain reference, in TF32, in the converter's, the
tracker's aligner's, the closer's batch matcher's and the map solve's
place.

In a ``--trace 1`` run the judge first reads the trace for the per-layer
readers: the device ns of the work launched inside each ``closer:match``
span (`counters["align_batch_device_ms"]`), and each kernel-2 launch's
device ns with its span's padded K (``kernel2_padded_k``, ``kernel2_ns``).
"""
from __future__ import annotations

import bisect
import collections
import json
import re
import time

import numpy as np
import torch

from .. import harness, spans
from ..reference import pwn as ref
from ..reference import pwn_slam as ref_slam
from ..reference.precision import no_tf32
from . import _pwn

# How near a gate's threshold the reference's quantity may lie for rounding
# to tip the gate: a share of the threshold.
GATE_BAND = 5e-3
KERNEL2 = re.compile(r"(^|[^A-Za-z0-9_])fused_aligner_batch_kernel([^A-Za-z0-9_]|$)")


class State:
    pass


def _configs(run):
    """The tracker's and closer's configurations and the map solve's
    `optimize_each_n_keyframes`; the configuration's other ``map``
    numbers are the program's constants, checked here."""
    from g2o_frontend_tpu_torch.slam import pwn_slam
    from g2o_frontend_tpu_torch.slam.map_closer import CloserConfig
    from g2o_frontend_tpu_torch.slam.pwn_tracker import PwnTrackerConfig

    m = run.config["map"]
    program = dict(iters=pwn_slam.ITERS, cg_iters=pwn_slam.CG_ITERS, final_iters=pwn_slam.FINAL_ITERS,
                   final_cg_iters=pwn_slam.FINAL_CG_ITERS, list_size=pwn_slam.LIST_SIZE)
    if any(m[k] != v for k, v in program.items()):
        raise ValueError(f"the configuration's map solve {m} is not the program's {program}")
    c = run.config["closer"]
    ccfg = CloserConfig(**{k: v for k, v in c.items() if k in CloserConfig.__dataclass_fields__})
    return PwnTrackerConfig(**run.config["tracker"]), ccfg, int(m["optimize_each_n_keyframes"])


def _counts(st):
    """The program's counters now."""
    return dict(batches=st.closer.batches, candidates=st.closer.candidates, padded=st.closer.padded,
                committed=st.closer.committed, rejected=st.closer.rejected, map_solves=st.reflector.solves,
                recomputes=st.slam.tracker.cache.recomputes, closer_calls=st.slam.closer_calls,
                closer_recomputes=st.slam.closer_recomputes, keyframes=st.slam.tracker.n_keyframes,
                captures=len(st.graphs.captures()))


def setup(run):
    t = time.perf_counter()
    from g2o_frontend_tpu_torch.graph import reflector
    from g2o_frontend_tpu_torch.slam import map_closer, pwn_slam, pwn_tracker
    from g2o_frontend_tpu_torch.utils import graphs

    st = State()
    st.tracker_module, st.closer, st.reflector, st.graphs = pwn_tracker, map_closer, reflector, graphs
    st.proj, st.conv_cfg, st.acfg = _pwn.program_configs(run)
    tcfg, ccfg, every = _configs(run)
    run.setup_parts["import"] = time.perf_counter() - t
    st.counts = _pwn.render(run)
    t = time.perf_counter()
    st.slam = pwn_slam.PwnSlam(st.proj, st.conv_cfg, st.acfg, tcfg, ccfg, optimize_each_n_keyframes=every,
                               device=run.device)
    n = len(st.counts)
    for i in range(int(run.traffic["prime_frames"])):
        st.slam.process_frame(_pwn.meters(run, st.counts[i % n]))
    run.setup_parts["prime"] = time.perf_counter() - t
    t = time.perf_counter()
    st.slam.warm_up(tuple(run.traffic["buckets"]), new_keyframes=int(run.traffic["max_window_keyframes"]),
                    new_closures=int(run.traffic["max_window_closures"]))
    run.setup_parts["warm_up"] = time.perf_counter() - t
    st.slam.record = pwn_slam.SlamRecord()
    st.next_frame = int(run.traffic["prime_frames"])
    return st


def window(run, st, seconds):
    slam, counts = st.slam, st.counts
    st.first = (slam.tracker.frame_count, len(slam.closer.batch_sizes))
    before = _counts(st)
    n_captures = len(st.graphs.captures())
    frame_s = []
    t0 = time.perf_counter()
    i, last = st.next_frame, int(run.traffic["last_frame"])
    while not frame_s or (time.perf_counter() - t0 - run.traced_seconds() < seconds and i < last):
        depth = _pwn.meters(run, counts[i % len(counts)])
        s0 = time.perf_counter()
        slam.process_frame(depth)
        frame_s.append(time.perf_counter() - s0)
        i += 1
        run.poll(time.perf_counter() - t0)
    total = time.perf_counter() - t0
    st.next_frame = i
    after = _counts(st)
    ks = slam.closer.batch_sizes[st.first[1]:]
    run.counters.update({k: after[k] - before[k] for k in before if k != "captures"})
    run.counters.update(
        frames=len(frame_s), window_captures=after["captures"] - before["captures"], captures=after["captures"],
        window_captured=[f"{c.stage} {list(c.shapes[:2])}" for c in st.graphs.captures()[n_captures:]],
        k_real=dict(sorted(collections.Counter(ks).items())),
        k_padded=dict(sorted(collections.Counter(st.closer.padded_k(k) for k in ks).items())),
        frame_ms_quartiles=[1e3 * harness.percentile(frame_s, q) for q in (25, 50, 75, 95, 99)])
    return harness.Window(len(frame_s), 0, {"frames_per_s": len(frame_s) / total,
                                           "frame_ms_p95": 1e3 * harness.percentile(frame_s, 95)})


def reference_solve(precision):
    """`reference/pwn_slam.lm_se3` in `precision`, in the form of the
    program's `optimize_se3` (the map solve's part of the control)."""
    from g2o_frontend_tpu_torch.solvers import pose_graph

    def solve(g, iters, cg_iters, precond):
        n, mask = int(g.pose_mask.sum()), g.pp_mask
        X, trace = ref_slam.lm_se3(
            pose_graph._pose7_to_T(g.poses[:n].double()).cpu().numpy(), g.pp_ij[mask].cpu().numpy(),
            pose_graph._pose7_to_T(g.pp_meas[mask].double()).cpu().numpy(), g.pp_info[mask].cpu().numpy(),
            int(torch.nonzero(g.fixed)[0]), iters, cg_iters, precision=precision, device=g.poses.device)
        poses = g.poses.clone()
        poses[:n] = pose_graph._T_to_pose7(X).to(poses.dtype)
        chi2 = torch.tensor(trace, device=g.poses.device)
        return g.with_poses(poses), pose_graph.OptStats(chi2, chi2.new_zeros(()), iters * cg_iters)

    return solve


def control(run, st, precision="tf32"):
    """Put the reference, computed in `precision`, in the converter's, the
    tracker's aligner's, the closer's batch matcher's and the map solve's
    place (the control of `correct`); returns the function that puts the
    program back."""
    cam, c, a = run.config["camera"], run.config["converter"], run.config["aligner"]
    trk, clo, refl = st.tracker_module, st.closer, st.reflector
    saved = trk.depth_to_cloud, trk.align, clo.match_clouds_batch, clo.stack_clouds, refl.optimize_se3
    trk.depth_to_cloud = lambda depth, projector, config: ref.convert(depth, cam, c, precision)
    trk.align = lambda r, cur, projector, guess, config: ref.align(r, cur, cam, guess, a, precision)
    clo.stack_clouds = list
    clo.match_clouds_batch = lambda refs, cur, projector, guesses, config: ref_slam.match_batch(
        refs, cur, cam, guesses, a, precision)
    refl.optimize_se3 = reference_solve(precision)

    def undo():
        trk.depth_to_cloud, trk.align, clo.match_clouds_batch, clo.stack_clouds, refl.optimize_se3 = saved

    return undo


def _match_device(run):
    """The traced window's device work launched inside each ``closer:match``
    span, into the counters: its device ms a batch, and each kernel-2
    launch's device ns with its span's padded K."""
    results = run.tracer.results if run.tracer is not None else None
    matches = [s for s in spans.program_spans() or () if s.name == "closer:match"]
    if results is None or not matches:
        return
    calls, device = {}, []
    for e in results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            device.append((name, e.duration_ns(), e.correlation_id(), e.linked_correlation_id()))
        elif name.startswith("cu"):
            calls[e.correlation_id()] = e.start_ns()
    ivs = sorted((s.start_ns, s.end_ns, s.request) for s in matches)
    starts = [a for a, _, _ in ivs]
    per, k2 = {}, []
    for name, ns, corr, linked in device:
        at = calls.get(corr if corr in calls else linked)
        k = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if k < 0 or at > ivs[k][1]:
            continue
        per[k] = per.get(k, 0) + ns
        if KERNEL2.search(name):
            k2.append((ivs[k][2], ns))
    run.counters["align_batch_device_ms"] = [per[k] / 1e6 for k in sorted(per)]
    run.counters["kernel2_padded_k"] = [k for k, _ in k2]
    run.counters["kernel2_ns"] = [ns for _, ns in k2]


def _near_gate(nz, inl, outl, ccfg):
    return any(abs(x - thr) <= GATE_BAND * thr for x, thr in (
        (nz, ccfg["frame_min_nonzero_threshold"]), (outl, ccfg["frame_max_outliers_threshold"]),
        (inl, ccfg["frame_min_inliers_threshold"])))


def _decision(m, ccfg):
    """(whether the reference's match `m` passes the gates, whether one of
    its gate quantities lies within the band of its threshold)."""
    nz, inl, outl = int(m.image_nonzeros), int(m.image_inliers), int(m.image_outliers)
    T, info = m.transform.double().cpu().numpy(), m.information.double().cpu().numpy()
    return ref_slam.gates(nz, inl, outl, T, info, ccfg), _near_gate(nz, inl, outl, ccfg)


def gate_verdict(port_passed, m, match64, ccfg):
    """"flip" where the program's gate decision differs from the float32
    reference's match `m` and from the float64 reference's (`match64()`,
    computed only then), each outside the band; "unsettled" where the two
    references decide apart; None where the program agrees."""
    passed, near = _decision(m, ccfg)
    if passed == bool(port_passed) or near:
        return None
    passed64, near64 = _decision(match64(), ccfg)
    return "flip" if passed64 == passed and not near64 else "unsettled"


def judge(run, st):
    if run.trace:
        _match_device(run)
    slam = st.slam
    rec, tr = slam.record, slam.tracker  # the record holds the window alone
    first_frame = st.first[0]
    metrics, traj = list(tr.metrics), np.stack(tr.trajectory)
    n_frames = len(metrics)
    committed = run.counters.get("committed", 0)
    batches = [b for b in rec.closer if hasattr(b, "key_frame")]
    votes = [c for c in rec.closer if hasattr(c, "decisions")]
    solves = rec.solves
    del st.slam, slam, tr
    if run.device != "cpu":
        torch.cuda.empty_cache()
    no_tf32()

    cam, acfg, tcfg = run.config["camera"], run.config["aligner"], run.config["tracker"]
    ccfg = run.config["closer"]
    pixels = cam["rows"] * cam["cols"]
    clouds = {}

    def cloud(k):
        if k not in clouds:
            clouds[k] = _pwn.ref_cloud(run, st.counts[k % len(st.counts)])
        return clouds[k]

    rng = np.random.default_rng([run.seed, 3])
    window_frames = np.arange(first_frame, n_frames)
    sample = sorted(int(k) for k in rng.choice(window_frames, size=min(int(run.traffic["judge_frames"]),
                                                                         len(window_frames)), replace=False))
    vals = {k: [] for k in ("t_gap_m", "r_gap_rad", "inlier_gap", "closure_t_gap_m", "closure_r_gap_rad",
                            "closure_inlier_gap", "image_inlier_gap", "closure_overlap_gap", "map_chi2_gap",
                            "map_position_gap_m")}
    flips = 0.0
    for k in sample:
        fr = rec.frames[k - first_frame]
        guess = np.linalg.inv(fr.anchor_T) @ fr.pose_before
        res = ref.align(cloud(fr.anchor_frame), cloud(k), cam, guess.astype(np.float32), acfg)
        inl = int(res.inliers)
        fallback = inl < max(1, tcfg["min_cloud_inliers"])
        g = fr.pose_before @ guess if fallback else fr.anchor_T @ res.T.double().cpu().numpy()
        if (k + 1) % tcfg["renormalize_every"] == 0:
            g = ref.renormalize(g)
        t_gap, r_gap = _pwn.pose_gap(traj[k], g)
        vals["t_gap_m"].append(t_gap)
        vals["r_gap_rad"].append(r_gap)
        vals["inlier_gap"].append(abs(metrics[k]["inliers"] - inl) / max(inl, 1))
        kf_ref = fallback or inl / pixels < tcfg["new_frame_inliers_fraction"]
        if kf_ref != metrics[k]["keyframe"] and not _pwn.near_decision(inl, run, _pwn.DECISION_BAND * inl + 1):
            flips += 1
    vals["keyframe_flips"] = [flips]

    verdicts = collections.Counter()
    n_b, n_c = int(run.traffic["judge_batches"]), int(run.traffic["judge_candidates"])
    drawn = sorted(rng.choice(len(batches), size=min(n_b, len(batches)), replace=False)) if batches else []
    for b in (batches[i] for i in drawn):
        for c in sorted(rng.choice(len(b.frames), size=min(n_c, len(b.frames)), replace=False)):
            m = ref_slam.match(cloud(b.frames[c]), cloud(b.key_frame), cam, b.guesses[c], acfg)
            T = m.transform.double().cpu().numpy()
            inl = int(m.image_inliers)
            passed = _decision(m, ccfg)[0]
            verdicts[gate_verdict(b.passed[c], m, lambda: ref_slam.match(
                _pwn.ref_cloud(run, st.counts[b.frames[c] % len(st.counts)], "float64"),
                _pwn.ref_cloud(run, st.counts[b.key_frame % len(st.counts)], "float64"), cam,
                b.guesses[c].astype(np.float64), acfg, "float64"), ccfg)] += 1
            _, inl_at, _ = ref_slam.overlap(cloud(b.frames[c]), cloud(b.key_frame), torch.as_tensor(
                b.transform[c], dtype=torch.float32, device=run.device), cam)
            vals["closure_overlap_gap"].append(abs(int(b.image_inliers[c]) - int(inl_at)) / max(int(inl_at), 1))
            if not (passed and b.passed[c]):
                continue  # a rejected candidate's transform goes nowhere; its alignment may wander
            t_gap, r_gap = _pwn.pose_gap(b.transform[c], T)
            vals["closure_t_gap_m"].append(t_gap)
            vals["closure_r_gap_rad"].append(r_gap)
            vals["closure_inlier_gap"].append(abs(int(b.cloud_inliers[c]) - int(m.cloud_inliers))
                                              / max(int(m.cloud_inliers), 1))
            vals["image_inlier_gap"].append(abs(int(b.image_inliers[c]) - inl) / max(inl, 1))
    vals["gate_flips"] = [float(verdicts["flip"])]
    vals["gate_unsettled"] = [float(verdicts["unsettled"])]

    consensus_flips = 0.0
    drawn = sorted(rng.choice(len(votes), size=min(n_b, len(votes)), replace=False)) if votes else []
    for v in (votes[i] for i in drawn):
        want = ref_slam.consensus(v.pose_from, v.pose_to, v.transform, v.from_in_current, v.counters_before, ccfg)
        consensus_flips += sum(a != b for a, b in zip(want, v.decisions))
    vals["consensus_flips"] = [consensus_flips]

    drawn = sorted(rng.choice(len(solves) - 1, size=min(int(run.traffic["judge_solves"]), len(solves) - 1),
                              replace=False)) if len(solves) > 1 else []
    for s in [solves[i] for i in drawn] + solves[-1:]:
        X, trace = ref_slam.lm_se3(s.poses_in, s.edges, s.transforms, s.information, s.gauge, s.iters, s.cg_iters,
                                   device=run.device)
        out = torch.as_tensor(s.poses_out, dtype=torch.float64, device=run.device)
        chi2_prog = ref_slam.chi2_se3(out, s.edges, s.transforms, s.information)
        vals["map_chi2_gap"].append(abs(chi2_prog - trace[-1]) / max(trace[-1], len(s.edges)))
        vals["map_position_gap_m"].append(float((out[:, :3, 3] - X[:, :3, 3]).norm(dim=-1).max()))
    if not solves:
        vals["map_chi2_gap"].append(float("nan"))
        vals["map_position_gap_m"].append(float("nan"))
    vals["no_closure"] = [0.0 if committed > 0 else 1.0]
    run.say("judge", f"{len(sample)} frames, {min(n_b, len(batches))} of {len(batches)} batches, "
            f"{min(n_b, len(votes))} of {len(votes)} consensus calls, {len(drawn) + bool(solves)} of {len(solves)} "
            f"map solves in the window")
    readings = harness.summarise(vals)
    run.say("judge", "not compared:", json.dumps({k: v for k, v in readings.items() if k not in run.limits}))
    return harness.checks_from(run, readings)
