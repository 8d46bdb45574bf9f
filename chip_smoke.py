#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: PWN dense RGB-D odometry (slice 1) and
PWN SLAM with loop closing (slice 2).

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA; JAX is not needed:

    python3 chip_smoke.py

Phases, one line each or more, any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/fused_aligner.cu and csrc/linearizer.cu from
     the checkout, both at once;
  3. kernel 1 (one aligner system) against its plain PyTorch version on the
     640x480 bench pair at three poses (identity, ground truth, a 5 cm /
     3 deg perturbation), and once more with the non-robust chi2 gate;
  4. align at 640x480 with the default configs: t_err gate, launch count,
     median convert/align times by CUDA events, and device times (profiler)
     of the kernel, its plain version, align and convert;
  5. the tracker command line over the bundled 120-frame TUM sequence at
     scale 2 (ATE gate, per-frame and --scan modes) and, as slice 1's
     main-path run whose kernel launches are counted, at scale 1 (640x480);
  6. kernel 2 (K candidate systems) at 640x480, K = 8 reference clouds
     rendered around the identity against one current cloud: against its
     plain version and against 8 kernel-1 calls;
  7. align_batch at 640x480, K = 8, against 8 serial align calls: T, inliers,
     launch counts, and the times of both;
  8. kernel 3 (the z-buffer linearizer) against its plain version on the
     z-buffer association of the bench pair, then align with
     association="zbuffer" at 640x480 (t_err gate, its launches counted);
  9. PWN SLAM at 640x480 over the bundled sequence (the app's own closer
     radius), then slice 2's main-path run: the loop closer with a 1 m
     radius over that map's keyframes and the hierarchical pose-graph
     solve, whose kernel-2 launches are counted; kernel 2 against its plain
     version on the inputs of every one of those launches, and its times at
     the largest batch; and the app's synthetic 40-frame orbit.
Then one JSON line of the kernels, the card's name and power limit, and a
last JSON line with the device.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEQ = os.path.join(REPO, "eval_out", "tum_seq")

# The bench pair of bench.py:61-94: three planes, a known small motion.
BENCH_PLANES = [
    ((0.0, 0.0, -1.0), -2.5),
    ((-1.0, 0.0, 0.0), -1.2),
    ((0.0, -1.0, 0.0), -0.9),
]
BENCH_XI = (0.04, -0.02, 0.05, 0.01, 0.03, -0.02)
BENCH_INLIERS = 251124  # aligner inliers on this pair in the JAX package's bench record (BENCH_r05)
EVAL_ATE_S2 = 0.346  # CPU tracker ATE on eval_out/tum_seq at --scale 2 (EVAL.md section 4)
K_CANDIDATES = 8
CANDIDATE_SEED = 7

# Peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores; the kernels do float32 arithmetic.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations per pixel, counted from csrc/pwn_terms.cuh: the gather
# and gates of pixel_terms (~80) plus linearize_terms (~250) plus the 29
# sums of the block reduction; linearize_terms plus the sums alone.
OPS_PER_PIXEL_SYSTEM = 360
OPS_PER_PIXEL_LINEARIZE = 280


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for `n_bytes` of device memory
    traffic and `n_ops` float32 operations at the card's peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bench_projector():
    from g2o_frontend_tpu_torch.pwn.projector import PinholeProjector

    H, W = 480, 640
    return PinholeProjector(rows=H, cols=W, fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                            min_distance=0.1, max_distance=10.0)


def bench_depth(T, device):
    import numpy as np

    from g2o_frontend_tpu_torch.utils.synth import render_planes_depth

    planes = [(np.array(n), d) for n, d in BENCH_PLANES]
    return render_planes_depth(T, bench_projector(), planes, device=device)


def bench_pair(device):
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.utils import lie

    T_gt = lie.se3_exp(torch.tensor(BENCH_XI, dtype=torch.float32)).numpy()
    return bench_depth(np.eye(4), device), bench_depth(T_gt, device), bench_projector(), T_gt


def event_ms(fn, runs):
    """Per-run milliseconds of `fn` by CUDA events, one pair per run."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def batch_ms(fn, n):
    """Milliseconds per call of `fn` over a run of n back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(fn, n):
    """Device milliseconds per call of `fn`: the CUDA kernel time that
    torch.profiler records over n calls, divided by n."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / 1000.0 / n


def compare_sums(phase, name, sk, sp, rtol=1e-3, per_row=True):
    """Kernel sums `sk` against plain sums `sp` ((..., 29) each): inliers
    equal, H, b and chi2 within `rtol` of their norms. With `per_row` every
    row must have inliers and gets a line; otherwise a row may have none
    (a candidate that does not overlap), and then both rows must be zero,
    and one line sums up the rows. Returns the max abs error."""
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa

    torch.cuda.synchronize()
    sk, sp = sk.reshape(-1, 29), sp.reshape(-1, 29)
    worst, n_empty = [0.0, 0.0, 0.0], 0
    for k in range(sk.shape[0]):
        Hk, bk, ck, ik = (x.double().cpu() for x in fa.unpack_sums(sk[k]))
        Hp, bp, cp, ip = (x.double().cpu() for x in fa.unpack_sums(sp[k]))
        label = name if sk.shape[0] == 1 else f"{name} [{k}]"
        check(int(ik) == int(ip), f"{label}: inliers {int(ik)} vs {int(ip)}")
        if int(ip) == 0 and not per_row:
            check(not bool(sk[k].any()) and not bool(sp[k].any()), f"{label}: sums of an empty system not zero")
            n_empty += 1
            continue
        check(int(ip) > 0, f"{label}: no inliers")
        dH = float((Hk - Hp).norm() / Hp.norm())
        db = float((bk - bp).norm() / bp.norm())
        dc = float(abs(ck - cp) / abs(cp))
        if per_row:
            say(phase, f"{label}: inliers {int(ik)} vs {int(ip)}; rel err H {dH:.2e} b {db:.2e} chi2 {dc:.2e}")
        check(dH <= rtol and db <= rtol and dc <= rtol,
              f"{label}: sums differ beyond rtol {rtol} (H {dH:.2e} b {db:.2e} chi2 {dc:.2e})")
        worst = [max(w, d) for w, d in zip(worst, (dH, db, dc))]
    err = float((sk - sp).abs().max())
    if not per_row:
        say(phase, f"{name}: {sk.shape[0]} rows, inliers equal, {n_empty} without inliers; "
            f"max rel err H {worst[0]:.2e} b {worst[1]:.2e} chi2 {worst[2]:.2e}; max abs err {err:.3e}")
    return err


def build_kernels():
    """Phase 2: one nvcc per CUDA source, all started together."""
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.ops import linearizer as lin

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [(mod, pool.submit(mod.build)) for mod in (fa, lin)]
        for mod, fut in builds:
            lib, secs, log = fut.result()
            ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s; " + " | ".join(ptxas))
    say("build", f"both kernels built in {time.perf_counter() - t0:.1f} s of wall time")


def phase_kernel1(ctx):
    """Phase 3: kernel 1 against its plain version at four settings."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.utils import lie

    acfg, device = ctx["acfg"], ctx["device"]
    perturb = lie.se3_exp(torch.tensor([0.05, 0.0, 0.0, 0.0, np.deg2rad(3.0), 0.0])).numpy()
    non_robust = dataclasses.replace(acfg, robust_kernel=False, inlier_max_chi2=2.0)
    err = 0.0
    for name, invT, cfg in (
        ("identity", np.eye(4), acfg),
        ("ground truth", ctx["inv_gt"], acfg),
        ("5cm/3deg", perturb @ ctx["inv_gt"], acfg),
        ("5cm/3deg, non-robust chi2 gate", perturb @ ctx["inv_gt"], non_robust),
    ):
        params = fa.params_from_invT(torch.as_tensor(invT, dtype=torch.float32, device=device))
        sk = fa.fused_system(ctx["cur_packed"], ctx["ref_table"], params, ctx["proj"], cfg)
        sp = fa.fused_system_reference(ctx["cur_packed"], ctx["ref_table"], params, ctx["proj"], cfg)
        err = max(err, compare_sums("kernel 1", name, sk, sp))
    return err


def phase_align(ctx):
    """Phase 4: align at 640x480 and the times of kernel 1."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import align
    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud

    acfg, proj, ref, cur = ctx["acfg"], ctx["proj"], ctx["ref"], ctx["cur"]
    before = fa.launches
    res = align(ref, cur, proj, config=acfg)
    torch.cuda.synchronize()
    grew = fa.launches - before
    t_err = float(np.linalg.norm((ctx["inv_gt"] @ res.T.double().cpu().numpy())[:3, 3]))
    say("align", f"t_err {t_err:.3e} m; inliers {int(res.inliers)} (JAX bench record {BENCH_INLIERS}); "
        f"valid {bool(res.valid)}; kernel launches +{grew}")
    per_align = ctx["per_align"]
    check(grew == per_align, f"launches grew by {grew}, not {per_align}")
    check(t_err < 0.01, f"t_err {t_err} >= 0.01 m")
    check(all(bool(torch.isfinite(x).all()) for x in (res.T, res.omega, res.mean)), "non-finite align result")
    for association in ("fused", "gather"):  # one kernel path for all three names
        before = fa.launches
        other = align(ref, cur, proj, config=dataclasses.replace(acfg, association=association))
        check(fa.launches - before == per_align and torch.equal(other.T, res.T),
              f"association={association!r} did not run the same kernel path")
    say("align", f"association 'fused' and 'gather' launch the kernel {per_align} times and give the same T")
    d_cur, ccfg = ctx["d_cur"], ctx["ccfg"]
    conv_ms = float(np.median(event_ms(lambda: depth_to_cloud(d_cur, proj, ccfg), 30)))
    align_ms = float(np.median(event_ms(lambda: align(ref, cur, proj, config=acfg), 30)))
    params = fa.params_from_invT(torch.as_tensor(ctx["inv_gt"], dtype=torch.float32, device=ctx["device"]))

    def kernel():
        return fa.fused_system(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)

    def plain():
        return fa.fused_system_reference(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)

    say("timing", f"CUDA events, median over 30 runs: depth_to_cloud {conv_ms:.3f} ms, align {align_ms:.3f} ms; "
        f"one system at 640x480, back-to-back calls: kernel {batch_ms(kernel, 200):.4f} ms, "
        f"plain {batch_ms(plain, 30):.4f} ms")
    kernel_ms, plain_ms = device_ms(kernel, 50), device_ms(plain, 20)
    say("timing", f"device time per call (torch.profiler): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"align {device_ms(lambda: align(ref, cur, proj, config=acfg), 10):.4f} ms, "
        f"depth_to_cloud {device_ms(lambda: depth_to_cloud(d_cur, proj, ccfg), 10):.4f} ms")
    n = proj.rows * proj.cols
    n_bytes = n * (fa.C_CUR + fa.C_REF) * 4 + (fa.N_PARAMS + fa.N_SUMS) * 4
    return kernel_ms, plain_ms, bound(n_bytes, n * OPS_PER_PIXEL_SYSTEM)


def phase_tracker(out_dir, per_align):
    """Phase 5: the tracker command line; returns the main-path launches."""
    import numpy as np

    from g2o_frontend_tpu_torch.apps import pwn_odometry
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa

    s2 = pwn_odometry.run([SEQ, "--device", "cuda", "--scale", "2", "--kf-fraction", "0.75",
                           "--out", os.path.join(out_dir, "traj_s2.txt")])
    ate2 = s2["ate"]["rmse"]
    say("tracker", f"scale 2: ATE {ate2:.4f} m (EVAL.md CPU record {EVAL_ATE_S2}); "
        f"keyframes {s2['keyframes']}/{s2['frames']}; {s2['frames_per_s']:.2f} frames/s")
    check(s2["frames"] == 120 and ate2 < 0.5, f"scale-2 ATE {ate2} >= 0.5 m")
    sc = pwn_odometry.run([SEQ, "--device", "cuda", "--scale", "2", "--kf-fraction", "0.75", "--scan",
                           "--out", os.path.join(out_dir, "traj_scan.txt")])
    say("tracker", f"scale 2, --scan (no per-frame sync): ATE {sc['ate']['rmse']:.4f} m; "
        f"keyframes {sc['keyframes']}/{sc['frames']}; {sc['frames_per_s']:.2f} frames/s")
    check(sc["frames"] == 120 and sc["ate"]["rmse"] < 0.5, f"scan ATE {sc['ate']['rmse']} >= 0.5 m")

    fa.launches = 0  # slice 1's main-path run: count the kernel launches of this run only
    s1 = pwn_odometry.run([SEQ, "--device", "cuda", "--scale", "1", "--kf-fraction", "0.75",
                           "--out", os.path.join(out_dir, "traj_s1.txt")])
    main_launches = fa.launches
    ate1 = s1["ate"]["rmse"]
    say("tracker", f"scale 1 (640x480): ATE {ate1:.4f} m; keyframes {s1['keyframes']}/{s1['frames']}; "
        f"{s1['frames_per_s']:.2f} frames/s; kernel launches {main_launches}")
    check(s1["frames"] == 120 and np.isfinite(ate1), "scale-1 run incomplete")
    check(main_launches == per_align * (s1["frames"] - 1), f"main path launched the kernel {main_launches} times")
    return main_launches


def candidates(ctx):
    """K reference clouds: the bench-pair reference rendered at K poses a few
    cm and degrees around the identity (fixed seed). Returns (stacked clouds,
    the list, (K, 4, 4) true current -> candidate transforms)."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud
    from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds
    from g2o_frontend_tpu_torch.utils import lie

    rng = np.random.default_rng(CANDIDATE_SEED)
    xis = np.concatenate([rng.normal(0.0, 0.03, (K_CANDIDATES, 3)), rng.normal(0.0, np.deg2rad(2.0), (K_CANDIDATES, 3))], 1)
    poses = lie.se3_exp(torch.as_tensor(xis, dtype=torch.float32)).double().numpy()
    clouds = [depth_to_cloud(bench_depth(P, ctx["device"]), ctx["proj"], ctx["ccfg"]) for P in poses]
    T_true = np.stack([np.linalg.inv(P) @ ctx["T_gt"] for P in poses])
    return stack_clouds(clouds), clouds, T_true, poses


def phase_kernel2(ctx):
    """Phase 6: kernel 2 against its plain version and against K kernel-1
    calls; times of kernel 2 and of its plain version."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa

    proj, acfg, cur_packed = ctx["proj"], ctx["acfg"], ctx["cur_packed"]
    refs = ctx["refs"]
    tables = fa.pack_ref(refs)
    check(tuple(tables.shape) == (K_CANDIDATES, proj.rows * proj.cols, fa.C_REF), f"tables {tuple(tables.shape)}")
    params = fa.params_from_invT(torch.as_tensor(np.linalg.inv(ctx["T_true"]), dtype=torch.float32,
                                                 device=ctx["device"]))
    sk = fa.fused_system_batch(cur_packed, tables, params, proj, acfg)
    sp = fa.fused_system_batch_reference(cur_packed, tables, params, proj, acfg)
    err = compare_sums("kernel 2", "vs plain", sk, sp)
    single = torch.stack([fa.fused_system(cur_packed, tables[k], params[k], proj, acfg) for k in range(K_CANDIDATES)])
    compare_sums("kernel 2", "vs kernel 1", sk, single, rtol=1e-6)
    say("kernel 2", f"max abs diff against {K_CANDIDATES} kernel-1 calls: {float((sk - single).abs().max()):.3e}")

    def kernel():
        return fa.fused_system_batch(cur_packed, tables, params, proj, acfg)

    def plain():
        return fa.fused_system_batch_reference(cur_packed, tables, params, proj, acfg)

    kernel_ms, plain_ms = device_ms(kernel, 50), device_ms(plain, 5)
    n = proj.rows * proj.cols
    n_bytes = n * fa.C_CUR * 4 + K_CANDIDATES * (n * fa.C_REF * 4 + (fa.N_PARAMS + fa.N_SUMS) * 4)
    bound_ms, bound_by = bound(n_bytes, K_CANDIDATES * n * OPS_PER_PIXEL_SYSTEM)
    say("timing", f"kernel 2, K={K_CANDIDATES} at 640x480, device time per call (torch.profiler): kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"back-to-back calls: kernel {batch_ms(kernel, 100):.4f} ms; max abs err vs plain {err:.3e}")


def phase_align_batch(ctx):
    """Phase 7: align_batch at K = 8 against K serial align calls."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import align, align_batch

    proj, acfg, cur = ctx["proj"], ctx["acfg"], ctx["cur"]
    # the closer's guess: the candidate's pose with the current one at the identity
    guesses = torch.as_tensor(np.linalg.inv(ctx["poses"]), dtype=torch.float32, device=ctx["device"])
    before1, before2 = fa.launches, fa.batch_launches
    rb = align_batch(ctx["refs"], cur, proj, guesses, acfg)
    torch.cuda.synchronize()
    grew1, grew2 = fa.launches - before1, fa.batch_launches - before2
    serial = [align(ref, cur, proj, guesses[k], acfg) for k, ref in enumerate(ctx["ref_list"])]
    dT = max(float((rb.T[k] - s.T).abs().max()) for k, s in enumerate(serial))
    t_err = max(float(np.linalg.norm((np.linalg.inv(ctx["T_true"][k]) @ rb.T[k].double().cpu().numpy())[:3, 3]))
                for k in range(K_CANDIDATES))
    inl_b = [int(x) for x in rb.inliers.cpu()]
    inl_s = [int(s.inliers) for s in serial]
    say("align_batch", f"K={K_CANDIDATES}: max |T - serial T| {dT:.2e}; max t_err {t_err:.3e} m; inliers {inl_b} "
        f"(serial {inl_s}); kernel-2 launches +{grew2}, kernel-1 launches +{grew1}")
    check(dT <= 1e-4, f"align_batch T differs from serial align by {dT}")
    check(inl_b == inl_s, "align_batch inliers differ from serial align")
    check(grew2 == ctx["per_align"] and grew1 == 0, f"launches +{grew2} (kernel 2), +{grew1} (kernel 1)")
    check(t_err < 0.01 and bool(torch.isfinite(rb.omega).all()), "align_batch did not converge")

    def batched():
        return align_batch(ctx["refs"], cur, proj, guesses, acfg)

    def one_by_one():
        return [align(ref, cur, proj, guesses[k], acfg) for k, ref in enumerate(ctx["ref_list"])]

    ev_b, ev_s = float(np.median(event_ms(batched, 10))), float(np.median(event_ms(one_by_one, 10)))
    dev_b, dev_s = device_ms(batched, 5), device_ms(one_by_one, 5)
    say("timing", f"align_batch K={K_CANDIDATES} vs {K_CANDIDATES} serial align: CUDA events median of 10 "
        f"{ev_b:.3f} ms vs {ev_s:.3f} ms; device time (torch.profiler) {dev_b:.4f} ms vs {dev_s:.4f} ms")


def phase_kernel3(ctx):
    """Phase 8: kernel 3 against its plain version on the bench pair's
    z-buffer association, its times, and align(association="zbuffer")."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.ops import linearizer as lin
    from g2o_frontend_tpu_torch.pwn import aligner as al

    proj, cur_packed = ctx["proj"], ctx["cur_packed"]
    zcfg = dataclasses.replace(ctx["acfg"], association="zbuffer")
    err, inputs = 0.0, None
    for name, invT, cfg in (
        ("ground truth", ctx["inv_gt"], zcfg),
        ("identity", np.eye(4), zcfg),
        ("identity, non-robust chi2 gate", np.eye(4), dataclasses.replace(zcfg, robust_kernel=False,
                                                                          inlier_max_chi2=2.0)),
    ):
        invT = torch.as_tensor(invT, dtype=torch.float32, device=ctx["device"])
        mask, ref_pts, ref_nrm = al._correspondences(ctx["ref"], ctx["cur"], invT, proj, cfg)
        p, n = al._remap(ref_pts, ref_nrm, invT)
        sk = lin.linearize_system(mask, p, n, cur_packed, cfg)
        sp = lin.linearize_system_reference(mask, p, n, cur_packed, cfg)
        err = max(err, compare_sums("kernel 3", name, sk, sp))
        if inputs is None:
            inputs = (mask, p, n, cfg)

    mask, p, n, cfg = inputs
    kernel_ms = device_ms(lambda: lin.linearize_system(mask, p, n, cur_packed, cfg), 50)
    plain_ms = device_ms(lambda: lin.linearize_system_reference(mask, p, n, cur_packed, cfg), 20)
    say("timing", f"kernel 3 at 640x480, device time per call (torch.profiler): kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")

    lin.launches, before1 = 0, fa.launches  # kernel 3's path: align with the z-buffer association
    res = al.align(ctx["ref"], ctx["cur"], proj, config=zcfg)
    torch.cuda.synchronize()
    launches = lin.launches
    t_err = float(np.linalg.norm((ctx["inv_gt"] @ res.T.double().cpu().numpy())[:3, 3]))
    say("align", f"association 'zbuffer': t_err {t_err:.3e} m; inliers {int(res.inliers)}; "
        f"kernel-3 launches {launches}, kernel-1 launches +{fa.launches - before1}")
    check(t_err < 0.01, f"z-buffer t_err {t_err} >= 0.01 m")
    check(launches == ctx["per_align"] and fa.launches == before1, f"kernel-3 launches {launches}")
    zb_ms = float(np.median(event_ms(lambda: al.align(ctx["ref"], ctx["cur"], proj, config=zcfg), 10)))
    say("timing", f"align 'zbuffer', CUDA events median of 10: {zb_ms:.3f} ms")
    n_pix, n_in = proj.rows * proj.cols, int(mask.sum())
    # the mask of every pixel; the remapped reference (24 B) and 18 current
    # channels (72 B) of each associated pixel
    n_bytes = n_pix + n_in * (24 + 72) + fa.N_SUMS * 4
    return err, kernel_ms, plain_ms, launches, bound(n_bytes, n_in * OPS_PER_PIXEL_LINEARIZE)


def keyframe_ate(nodes, timestamps):
    """ATE (m, rmse) of keyframe poses against the sequence's ground truth."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.utils import evaluation, lie

    T = np.stack([n.transform for n in nodes])
    q = lie.mat2quat_full(torch.as_tensor(T[:, :3, :3], dtype=torch.float32)).numpy()
    poses7 = np.concatenate([T[:, :3, 3], q[:, 1:], q[:, :1]], 1)
    ts_gt, gt7 = tum.read_trajectory(os.path.join(SEQ, "groundtruth.txt"))
    ts = np.asarray([timestamps[n.payload["frame"]] for n in nodes])
    return evaluation.ate(ts, poses7, ts_gt, gt7)["rmse"]


def phase_slam(ctx, out_dir):
    """Phase 9: PWN SLAM at 640x480. Returns kernel 2's launches on slice
    2's main path (the loop closer over the sequence's keyframe map), its
    max abs error against the plain version over every call of that run,
    and its device time, its plain version's and its bound at the run's
    largest batch."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import pwn_odometry, pwn_slam
    from g2o_frontend_tpu_torch.graph.reflector import MapReflector
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.slam.map_closer import CloserConfig, MapCloser
    from g2o_frontend_tpu_torch.slam.map_merger import MapMerger
    from g2o_frontend_tpu_torch.slam.pwn_tracker import PwnTracker, PwnTrackerConfig

    device = ctx["device"]
    r = pwn_slam.run([SEQ, "--device", "cuda", "--scale", "1", "--kf-fraction", "0.75",
                      "--out-map", os.path.join(out_dir, "map_s1.npz"),
                      "--out-traj", os.path.join(out_dir, "slam_s1.txt")])
    say("slam", f"app, scale 1 (640x480), default 3 m closer radius: frames {r['frames']}, keyframes "
        f"{r['keyframes']}, closures {r['closures']}, batches {r['batch_sizes']}, final chi2 {r['final_chi2']:.6g}, "
        f"ATE {r['ate']['rmse']:.4f} m, {r['frames_per_s']:.2f} frames/s")
    check(r["frames"] == 120 and np.isfinite(r["final_chi2"]), "the SLAM app run is incomplete")

    # slice 2's main path: loop closing over the 640x480 keyframe map with a
    # 1 m candidate radius, the closer's frame gates scaled from the JAX
    # synthetic mode's 96x128 values to the image area
    proj, ccfg, acfg = pwn_odometry.configs(1, "kinect")
    area = proj.rows * proj.cols / (96 * 128)
    cfg = CloserConfig(translational_distance=1.0, consensus_min_times_checked=1,
                       frame_min_nonzero_threshold=int(2000 * area), frame_max_outliers_threshold=int(6000 * area),
                       frame_min_inliers_threshold=int(2000 * area))
    index = tum.read_depth_index(SEQ)
    timestamps = [ts for ts, _ in index]
    tracker = PwnTracker(proj, ccfg, acfg, PwnTrackerConfig(new_frame_inliers_fraction=0.75), device=device)
    for _, rel in index:
        tracker.process_frame(tum.load_depth_png(os.path.join(SEQ, rel)))
    mgr = tracker.manager
    nodes = list(mgr.nodes)
    ate_before = keyframe_ate(nodes, timestamps)
    closer = MapCloser(mgr, tracker.cache, proj, acfg, cfg)
    merger = MapMerger(mgr, list_size=5)
    reflector = MapReflector(mgr, device=device)
    # keep the inputs of every kernel-2 call of this run, to hold the kernel
    # against its plain version at the shapes the closer gives it (the
    # tables of one batch are one tensor, shared by its calls)
    calls, batch_kernel = [], fa.fused_system_batch

    def recording(cur_packed, ref_tables, params, projector, acfg_):
        calls.append((cur_packed, ref_tables, params, projector, acfg_))
        return batch_kernel(cur_packed, ref_tables, params, projector, acfg_)

    fa.fused_system_batch = recording
    fa.batch_launches, before1 = 0, fa.launches
    t0 = time.perf_counter()
    committed = 0
    try:
        for node in nodes[2:]:
            committed += len(closer.process_key_node(node))
            merger.process_key_node(node)
    finally:
        fa.fused_system_batch = batch_kernel
    t_close = time.perf_counter() - t0
    chi2, cg = reflector.optimize_hierarchical(iters=10, cg_iters=60)
    t_opt = time.perf_counter() - t0 - t_close
    launches = fa.batch_launches
    ate_after = keyframe_ate(nodes, timestamps)
    batches = closer.batch_sizes
    say("slam", f"closer, 1 m radius over {len(nodes)} keyframes: {len(batches)} batches, K {batches}, "
        f"{committed} closures committed in {t_close:.2f} s; hierarchical solve chi2 {chi2:.6g} "
        f"(cg {cg}) in {t_opt:.2f} s; keyframe ATE {ate_before:.4f} m before, {ate_after:.4f} m after; "
        f"kernel-2 launches {launches}, kernel-1 launches +{fa.launches - before1}")
    check(len(batches) >= 1 and launches == ctx["per_align"] * len(batches),
          f"kernel-2 launches {launches} for {len(batches)} batches")
    check(committed >= 1, "no closure committed")
    check(np.isfinite(chi2), "non-finite chi2 after the hierarchical solve")
    check(len(calls) == launches, f"{len(calls)} kernel-2 calls recorded, {launches} launches counted")

    # kernel 2 against its plain version on every call of the closer's run,
    # one line for each batch (its calls share one tables tensor)
    err, i = 0.0, 0
    for b in range(len(batches)):
        j = i
        while j < len(calls) and calls[j][1] is calls[i][1]:
            j += 1
        sk = torch.cat([fa.fused_system_batch(*c) for c in calls[i:j]])
        sp = torch.cat([fa.fused_system_batch_reference(*c) for c in calls[i:j]])
        name = f"closer batch {b} (K={calls[i][1].shape[0]}, {j - i} calls)"
        err = max(err, compare_sums("kernel 2", name, sk, sp, per_row=False))
        i = j
    check(i == len(calls), f"{len(calls) - i} kernel-2 calls outside the closer's batches")
    # times at the closer's largest batch, its last (converged) system
    cur_packed, tables, params, proj_, acfg_ = max(reversed(calls), key=lambda c: c[1].shape[0])
    K = tables.shape[0]
    kernel_ms = device_ms(lambda: fa.fused_system_batch(cur_packed, tables, params, proj_, acfg_), 20)
    plain_ms = device_ms(lambda: fa.fused_system_batch_reference(cur_packed, tables, params, proj_, acfg_), 2)
    say("timing", f"kernel 2 on the closer's largest batch, K={K} at {proj_.rows}x{proj_.cols}, device time per call "
        f"(torch.profiler): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
    n = proj_.rows * proj_.cols
    n_bytes = n * fa.C_CUR * 4 + K * (n * fa.C_REF * 4 + (fa.N_PARAMS + fa.N_SUMS) * 4)
    k2 = (launches, err, kernel_ms, plain_ms, bound(n_bytes, K * n * OPS_PER_PIXEL_SYSTEM))

    syn = pwn_slam.run(["--synthetic", "--frames", "40", "--device", "cuda",
                        "--out-map", os.path.join(out_dir, "map_syn.npz"),
                        "--out-traj", os.path.join(out_dir, "slam_syn.txt")])
    say("slam", f"app, --synthetic --frames 40: keyframes {syn['keyframes']}, closures {syn['closures']}, "
        f"batches {syn['batch_sizes']}, final chi2 {syn['final_chi2']:.6g}")
    check(syn["keyframes"] == 8 and syn["closures"] == 2, "synthetic run: expected 8 keyframes and 2 closures")
    return k2


def run(out_dir):
    import numpy as np
    import torch

    import g2o_frontend_tpu_torch  # noqa: F401  (turns TF32 off)
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig
    from g2o_frontend_tpu_torch.pwn.converter import ConverterConfig, depth_to_cloud

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    device = torch.device("cuda:0")

    # 2. build
    build_kernels()

    d_ref, d_cur, proj, T_gt = bench_pair(device)
    ccfg, acfg = ConverterConfig(), AlignerConfig()
    ref, cur = depth_to_cloud(d_ref, proj, ccfg), depth_to_cloud(d_cur, proj, ccfg)
    ctx = dict(device=device, proj=proj, ccfg=ccfg, acfg=acfg, ref=ref, cur=cur, d_cur=d_cur, T_gt=T_gt,
               inv_gt=np.linalg.inv(T_gt), cur_packed=fa.pack_cur(cur), ref_table=fa.pack_ref(ref),
               per_align=acfg.outer_iterations * acfg.inner_iterations + 1)

    err1 = phase_kernel1(ctx)  # 3
    k1_ms, k1_plain_ms, k1_bound = phase_align(ctx)  # 4
    k1_launches = phase_tracker(out_dir, ctx["per_align"])  # 5
    ctx["refs"], ctx["ref_list"], ctx["T_true"], ctx["poses"] = candidates(ctx)
    phase_kernel2(ctx)  # 6
    phase_align_batch(ctx)  # 7
    err3, k3_ms, k3_plain_ms, k3_launches, k3_bound = phase_kernel3(ctx)  # 8
    k2_launches, err2, k2_ms, k2_plain_ms, k2_bound = phase_slam(ctx, out_dir)  # 9

    kernels = []
    for name, source, replaces, launches, err, ms, plain_ms, (bound_ms, bound_by) in (
        ("fused_aligner", "fused_aligner.cu", "ops/pallas_aligner.py:627", k1_launches, err1, k1_ms, k1_plain_ms,
         k1_bound),
        ("fused_aligner_batch", "fused_aligner.cu", "ops/pallas_aligner.py:730", k2_launches, err2, k2_ms,
         k2_plain_ms, k2_bound),
        ("linearizer", "linearizer.cu", "ops/pallas_linearizer.py:164", k3_launches, err3, k3_ms, k3_plain_ms,
         k3_bound),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"g2o_frontend_tpu_torch/csrc/{source}",
            "replaces": f"g2o_frontend_tpu/{replaces}", "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        check(launches > 0, f"{name} was not launched on its path")
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "g2o_frontend_tpu.")) or
                 m == "g2o_frontend_tpu")
    check(not bad, f"the port imported {bad}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            kind, count = run(out_dir)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    say("done", f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
