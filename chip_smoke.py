#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: PWN dense RGB-D odometry (slice 1),
PWN SLAM with loop closing (slice 2) and the gather probes.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA; JAX is not needed:

    python3 chip_smoke.py

Phases, one line each or more, any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/fused_aligner.cu, csrc/linearizer.cu and
     csrc/gather_probe.cu from the checkout, all at once;
  3. kernel 1 (one aligner system) against its plain PyTorch version on the
     640x480 bench pair at three poses (identity, ground truth, a 5 cm /
     3 deg perturbation), and once more with the non-robust chi2 gate;
  4. align at 640x480 with the default configs: t_err gate, launch count,
     median convert/align times by CUDA events, device times of align and
     convert (torch.profiler) and of the kernel and its plain version;
  5. the tracker command line over the bundled 120-frame TUM sequence at
     scale 2 (ATE gate, per-frame and --scan modes) and, as slice 1's
     main-path run whose kernel launches are counted, at scale 1 (640x480);
  6. kernel 2 (K candidate systems, the tiled design) at 640x480, K = 8
     reference clouds rendered around the identity against one current
     cloud: against its plain version, against 8 kernel-1 calls and against
     the previous batch design, two launches bit-equal, and timed in turns
     with the previous design;
  7. align_batch at 640x480, K = 8, against 8 serial align calls: T, inliers,
     launch counts, and the times of both;
  8. kernel 3 (the z-buffer linearizer) against its plain version on the
     z-buffer association of the bench pair, then align with
     association="zbuffer" at 640x480 (t_err gate, its launches counted);
  9. PWN SLAM at 640x480 over the bundled sequence (the app's own closer
     radius), then slice 2's main-path run: the loop closer with a 1 m
     radius over that map's keyframes and the hierarchical pose-graph
     solve, whose kernel-2 launches are counted; kernel 2 against its plain
     version on the inputs of every one of those launches (two launches
     bit-equal), timed in turns with the previous batch design at each K of
     the run; and the app's synthetic 40-frame orbit;
 10. the gather probes of apps/profile_gather.py: the TPU script's four
     probes at its shapes, each kernel bit-equal to its plain version (NaN in
     the same places), with in-range indices and with wrapped and
     out-of-range ones; the flat gather at 640x480 over the bench pair's
     reference table (identity, projective, random) and, projective, over
     phase 6's K = 8 tables and phase 9's largest batch, each timed beside
     torch.gather and its bound; kernel 2's gather without its arithmetic
     on the inputs of phases 6 and 9, equal to its plain version and timed
     in turns with kernel 2, whose time it gives as a multiple of the
     loads' alone;
 11. the rest of PWN at 640x480, each step also run by the port on the CPU
     on the same inputs and compared: (a) `pwn_slam --conf` and
     `pwn_odometry --conf` with g2o_frontend_tpu_torch/conf/pwn_slam_tum.conf
     over the whole sequence, their kernel launches counted; (b) the map
     merger's cloud fusion over phase 9's 1 m-radius keyframe map (each
     fused pair a 614,400-slot model), ms per fusion and the share of
     collapse decisions that differ from the CPU; (c) voxel downsampling of
     each fused cloud at 0.02 and 0.1 m; (d) plane extraction on the bench
     pair and five TUM frames, and the depth calibration over those frames;
     (e) the manifold Voronoi extractor over the map's last 30 keyframes
     (9.2 M points into the 100x100 grid at 0.2 m) and the diagram; (f) a
     640x480 cloud through a `.pwn` file and back, bit-equal, and the
     cloud_aligner command line on two TUM frames.
Every kernel's device time, and its plain version's, is the slope of CUDA
graph replays timed by CUDA events (utils/profiling.graph_ms), in the phase
that checks the kernel. Then one JSON line of the kernels, the card's name
and power limit, and a last JSON line with the device.
"""
import concurrent.futures
import dataclasses
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEQ = os.path.join(REPO, "eval_out", "tum_seq")
CONF = os.path.join(REPO, "g2o_frontend_tpu_torch", "conf", "pwn_slam_tum.conf")

BENCH_INLIERS = 251124  # aligner inliers on the bench pair in the JAX package's bench record (BENCH_r05)
EVAL_ATE_S2 = 0.346  # CPU tracker ATE on eval_out/tum_seq at --scale 2 (EVAL.md section 4)

# Float32 operations per pixel, counted from csrc/pwn_terms.cuh: the gather
# and gates of pixel_terms (~80) plus linearize_terms (~250) plus the 29
# sums of the block reduction; linearize_terms plus the sums alone.
OPS_PER_PIXEL_SYSTEM = 360
OPS_PER_PIXEL_LINEARIZE = 280


def check(cond, msg):
    if not cond:
        from g2o_frontend_tpu_torch.utils.profiling import CheckFailure

        raise CheckFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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


def ptxas_lines(log):
    """[(kernel name, its ptxas lines on registers, stack and spills)] from
    nvcc's ``-Xptxas -v`` output; the name is taken from the mangled one."""
    import re

    kernels = [("(unnamed)", [])]
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?(?<!\d)\d+([a-z][a-z_]*_kernel)", ln)
        if entry:
            kernels.append((entry.group(1), []))
        elif "registers" in ln or "spill" in ln:
            kernels[-1][1].append(ln.replace("ptxas info    :", "").strip())
    return [k for k in kernels if k[1]]


def build_kernels():
    """Phase 2: one nvcc per CUDA source, all started together."""
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.ops import gather_probe as gp
    from g2o_frontend_tpu_torch.ops import linearizer as lin

    t0 = time.perf_counter()
    modules = (fa, lin, gp)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = [(mod, pool.submit(mod.build)) for mod in modules]
        for mod, fut in builds:
            lib, secs, log = fut.result()
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s")
            for name, lines in ptxas_lines(log):
                say("build", f"  {name}: " + " | ".join(lines))
    say("build", f"{len(modules)} sources built in {time.perf_counter() - t0:.1f} s of wall time")


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
    from g2o_frontend_tpu_torch.apps.profile_gather import system_bytes
    from g2o_frontend_tpu_torch.utils.profiling import bound, device_ms, event_ms, graph_ms

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

    say("timing", f"CUDA events, median over 30 runs: depth_to_cloud {conv_ms:.3f} ms, align {align_ms:.3f} ms")
    kernel_ms, plain_ms = graph_ms(kernel, params, 50), graph_ms(plain, params, 20)
    say("timing", f"one system at 640x480, device ms per call by CUDA graph replays: kernel {kernel_ms:.6f}, plain "
        f"{plain_ms:.6f}; by torch.profiler: kernel {device_ms(kernel, 50):.6f}, "
        f"align {device_ms(lambda: align(ref, cur, proj, config=acfg), 10):.4f}, "
        f"depth_to_cloud {device_ms(lambda: depth_to_cloud(d_cur, proj, ccfg), 10):.4f}")
    n_bytes = system_bytes(ctx["cur_packed"], params, proj, fa.N_SUMS)
    return kernel_ms, plain_ms, bound(n_bytes, proj.rows * proj.cols * OPS_PER_PIXEL_SYSTEM)


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

    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud
    from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds
    from g2o_frontend_tpu_torch.utils import synth

    poses = synth.candidate_poses(synth.K_CANDIDATES)
    clouds = [depth_to_cloud(synth.bench_depth(P, ctx["device"]), ctx["proj"], ctx["ccfg"]) for P in poses]
    T_true = np.stack([np.linalg.inv(P) @ ctx["T_gt"] for P in poses])
    return stack_clouds(clouds), clouds, T_true, poses


def phase_kernel2(ctx):
    """Phase 6: kernel 2 at K = 8 against its plain version, against K
    kernel-1 calls and against the previous batch design, each at the plain
    tolerance (inliers equal, H, b and chi2 within rtol 1e-3): the tiled
    kernel adds each system's terms in another float32 order than kernel 1
    and the previous design, whose blocks of 256 pixels agreed to the bit,
    so the three no longer do; inliers, sums of ones, stay exact. Two
    launches give the same bits. Times of the previous design and of kernel
    2 in turns, and of the plain version. Keeps the tables and params in
    ctx["k8"] for phase 10."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps.profile_gather import bit_equal, system_bytes
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.utils.profiling import bound, graph_ms, in_turns
    from g2o_frontend_tpu_torch.utils.synth import K_CANDIDATES

    proj, acfg, cur_packed = ctx["proj"], ctx["acfg"], ctx["cur_packed"]
    refs = ctx["refs"]
    tables = fa.pack_ref(refs)
    check(tuple(tables.shape) == (K_CANDIDATES, proj.rows * proj.cols, fa.C_REF), f"tables {tuple(tables.shape)}")
    params = fa.params_from_invT(torch.as_tensor(np.linalg.inv(ctx["T_true"]), dtype=torch.float32,
                                                 device=ctx["device"]))
    args = (cur_packed, tables, params, proj, acfg)
    sk = fa.fused_system_batch(*args)
    err = compare_sums("kernel 2", "vs plain", sk, fa.fused_system_batch_reference(*args))
    ctx["k8"] = args
    single = torch.stack([fa.fused_system(cur_packed, tables[k], params[k], proj, acfg) for k in range(K_CANDIDATES)])
    compare_sums("kernel 2", "vs kernel 1", sk, single)
    old = fa._fused_system_batch_grid(*args)
    compare_sums("kernel 2", "vs the previous batch kernel", sk, old)
    check(bit_equal(sk, fa.fused_system_batch(*args)), "two launches of kernel 2 differ")
    say("kernel 2", f"two launches bit-equal; max abs diff against {K_CANDIDATES} kernel-1 calls "
        f"{float((sk - single).abs().max()):.3e}, against the previous batch kernel {float((sk - old).abs().max()):.3e}")

    kernel_ms, previous_ms = in_turns(lambda: fa.fused_system_batch(*args), lambda: fa._fused_system_batch_grid(*args),
                                      params, 50)
    plain_ms = graph_ms(lambda: fa.fused_system_batch_reference(*args), params, 8)
    n_bytes = system_bytes(cur_packed, params, proj, fa.N_SUMS)
    bound_ms, bound_by = bound(n_bytes, K_CANDIDATES * proj.rows * proj.cols * OPS_PER_PIXEL_SYSTEM)
    layout = fa.batch_layout(proj.rows, proj.cols, K_CANDIDATES)
    say("timing", f"kernel 2, K={K_CANDIDATES} at 640x480 ({layout.blocks} blocks, {layout.group} candidates a block), "
        f"device ms per call by CUDA graph replays in turns: kernel {kernel_ms:.6f}, previous batch kernel "
        f"{previous_ms:.6f} ({previous_ms / kernel_ms:.2f}x), plain {plain_ms:.6f}; bound {bound_ms:.6f} "
        f"({bound_by}, {n_bytes} B, {100 * bound_ms / kernel_ms:.1f}% of it); max abs err vs plain {err:.3e}")


def phase_align_batch(ctx):
    """Phase 7: align_batch at K = 8 against K serial align calls."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import align, align_batch
    from g2o_frontend_tpu_torch.utils.profiling import device_ms, event_ms
    from g2o_frontend_tpu_torch.utils.synth import K_CANDIDATES

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
    from g2o_frontend_tpu_torch.utils.profiling import bound, event_ms, graph_ms

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
    kernel_ms = graph_ms(lambda: lin.linearize_system(mask, p, n, cur_packed, cfg), mask, 50)
    plain_ms = graph_ms(lambda: lin.linearize_system_reference(mask, p, n, cur_packed, cfg), mask, 20)
    say("timing", f"kernel 3 at 640x480, device ms per call by CUDA graph replays: kernel {kernel_ms:.6f}, "
        f"plain {plain_ms:.6f}")

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
    and at the run's largest batch its time and the previous batch
    design's (in turns), its plain version's time and its bound. Also
    times the two designs in turns at every other K of the run. Keeps the
    largest batch's inputs in ctx["k_max"] for phase 10."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import pwn_odometry, pwn_slam
    from g2o_frontend_tpu_torch.apps.profile_gather import bit_equal, system_bytes
    from g2o_frontend_tpu_torch.graph.reflector import MapReflector
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.slam.map_closer import CloserConfig, MapCloser
    from g2o_frontend_tpu_torch.slam.map_merger import MapMerger
    from g2o_frontend_tpu_torch.slam.pwn_tracker import PwnTracker, PwnTrackerConfig
    from g2o_frontend_tpu_torch.utils.profiling import bound, graph_ms, in_turns

    device = ctx["device"]
    fa.launches, fa.batch_launches = 0, 0
    r = pwn_slam.run([SEQ, "--device", "cuda", "--scale", "1", "--kf-fraction", "0.75",
                      "--out-map", os.path.join(out_dir, "map_s1.npz"),
                      "--out-traj", os.path.join(out_dir, "slam_s1.txt")])
    ctx["app_launches"] = (fa.launches, fa.batch_launches)
    say("slam", f"app, scale 1 (640x480), default 3 m closer radius: frames {r['frames']}, keyframes "
        f"{r['keyframes']}, closures {r['closures']}, batches {r['batch_sizes']}, final chi2 {r['final_chi2']:.6g}, "
        f"ATE {r['ate']['rmse']:.4f} m, {r['frames_per_s']:.2f} frames/s; kernel-1 launches {fa.launches}, "
        f"kernel-2 launches {fa.batch_launches}")
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
    ctx["slam"] = dict(tracker=tracker, nodes=nodes)  # the 1 m-radius map, for phase 11
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
    # one line for each batch (its calls share one tables tensor); each
    # call launched twice, bit-equal
    err, i = 0.0, 0
    for b in range(len(batches)):
        j = i
        while j < len(calls) and calls[j][1] is calls[i][1]:
            j += 1
        sk = torch.cat([fa.fused_system_batch(*c) for c in calls[i:j]])
        check(bit_equal(sk, torch.cat([fa.fused_system_batch(*c) for c in calls[i:j]])),
              f"closer batch {b}: two launches of kernel 2 differ")
        sp = torch.cat([fa.fused_system_batch_reference(*c) for c in calls[i:j]])
        name = f"closer batch {b} (K={calls[i][1].shape[0]}, {j - i} calls, two launches bit-equal)"
        err = max(err, compare_sums("kernel 2", name, sk, sp, per_row=False))
        i = j
    check(i == len(calls), f"{len(calls) - i} kernel-2 calls outside the closer's batches")

    # the tiled and the previous batch design in turns at each K of the run,
    # on its last (converged) call of that K, after holding them equal there
    last = {c[1].shape[0]: c for c in calls}
    times = {}
    for K in sorted(last):
        c = last[K]
        compare_sums("kernel 2", f"K={K} vs the previous batch kernel", fa.fused_system_batch(*c),
                     fa._fused_system_batch_grid(*c), per_row=False)
        times[K] = in_turns(lambda: fa.fused_system_batch(*c), lambda: fa._fused_system_batch_grid(*c), c[2], 20)
        layout = fa.batch_layout(c[3].rows, c[3].cols, K)
        say("timing", f"kernel 2 at K={K} ({layout.blocks} blocks, {layout.group} candidates a block), device ms per call "
            f"by CUDA graph replays in turns: kernel {times[K][0]:.6f}, previous batch kernel {times[K][1]:.6f} "
            f"({times[K][1] / times[K][0]:.2f}x)")
    K = max(last)
    slower = [k for k, (new, old) in times.items() if (new >= old if k == K else new > 1.05 * old)]
    say("timing", f"kernel 2 against the previous batch kernel: faster at the largest batch (K={K}) and within 1.05x "
        f"at every other K: {'yes' if not slower else 'no, at K=' + str(slower)}")

    # the largest batch: its plain version's time and the bound
    cur_packed, tables, params, proj_, acfg_ = ctx["k_max"] = last[K]
    kernel_ms, previous_ms = times[K]
    plain_ms = graph_ms(lambda: fa.fused_system_batch_reference(cur_packed, tables, params, proj_, acfg_), params, 4)
    n_bytes = system_bytes(cur_packed, params, proj_, fa.N_SUMS)
    k2_bound = bound(n_bytes, K * proj_.rows * proj_.cols * OPS_PER_PIXEL_SYSTEM)
    say("timing", f"kernel 2 on the closer's largest batch, K={K} at {proj_.rows}x{proj_.cols}, device ms per call by "
        f"CUDA graph replays: kernel {kernel_ms:.6f}, previous {previous_ms:.6f}, plain {plain_ms:.6f}; bound "
        f"{k2_bound[0]:.6f} ({k2_bound[1]}, {n_bytes} B, {100 * k2_bound[0] / kernel_ms:.1f}% of it)")
    k2 = (launches, err, kernel_ms, previous_ms, plain_ms, k2_bound)

    syn = pwn_slam.run(["--synthetic", "--frames", "40", "--device", "cuda",
                        "--out-map", os.path.join(out_dir, "map_syn.npz"),
                        "--out-traj", os.path.join(out_dir, "slam_syn.txt")])
    say("slam", f"app, --synthetic --frames 40: keyframes {syn['keyframes']}, closures {syn['closures']}, "
        f"batches {syn['batch_sizes']}, final chi2 {syn['final_chi2']:.6g}")
    check(syn["keyframes"] == 8 and syn["closures"] == 2, "synthetic run: expected 8 keyframes and 2 closures")
    return k2


def phase_gather(ctx):
    """Phase 10: the probe path of apps/profile_gather.py. (a) The TPU
    script's four probes at its shapes and inputs, each driven as a path of
    its own (launch count set to 0 just before, read just after), each
    kernel bit-equal to its plain version, NaN in the same places; then the
    four with wrapped and out-of-range indices. (b) The flat gather at
    640x480 over the bench pair's reference table (identity, projective,
    random) and, in the projective pattern, over phase 6's K = 8 tables and
    phase 9's largest batch; each timed rotating over input copies that
    stream twice the L2. (c) Kernel 2's gather without its arithmetic
    (`projective_gather_sum`) on the inputs of phase 6's K = 8 call and of
    phase 9's largest batch, equal to its plain version, timed in turns with
    kernel 2. Returns the kernels-line entries of the four probes, of the
    640x480 projective gather and of (c) at phase 9's largest batch."""
    import torch

    from g2o_frontend_tpu_torch.apps import profile_gather as pg
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.ops import gather_probe as gp

    def counted(g):
        """Drive g's path once; its launches and the max abs error of its
        output against the plain version (NaN positions already equal)."""
        gp.launches = 0
        out, ref = pg.check(g)
        launches = gp.launches
        check(launches == 1, f"{g.name}: {launches} kernel launches, not 1")
        return launches, float((out - ref).nan_to_num(0.0).abs().max())

    def entry(name, g, launches, err, m):
        return {"name": name, "route": "cuda", "source": "g2o_frontend_tpu_torch/csrc/gather_probe.cu",
                "replaces": g.replaces, "launches": launches, "max_abs_err": err, "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": m["library_ms"]}

    entries = []
    names = ("take_along_lanes_8x128", "take_along_lanes_8x1024", "take_along_sublanes_1024x128",
             "flat_gather_64x128")
    for name, g in zip(names, pg.tpu_probes(ctx["device"])):
        entries.append(entry(name, g, *counted(g), pg.measure(g, n=50)))
    for g in pg.out_of_range_probes(ctx["device"]):
        counted(g)
    params = fa.params_from_invT(torch.as_tensor(ctx["inv_gt"], dtype=torch.float32, device=ctx["device"]))
    batches = [ctx["k8"], ctx["k_max"]]
    for g in pg.aligner_gathers(ctx["cur_packed"], ctx["ref_table"], params, ctx["proj"], [c[:4] for c in batches]):
        launches, err = counted(g)
        m = pg.measure(g, n=20)
        if g.name.endswith(" projective"):  # the bench pair's own table
            entries.append(entry("flat_gather_640x480_projective", g, launches, err, m))
    for cur_packed, tables, params_k, proj, acfg in batches:
        gp.launches = 0
        pg.check_traffic(cur_packed, tables, params_k, proj)
        launches = gp.launches
        check(launches == 1, f"kernel 2's gather, K={tables.shape[0]}: {launches} kernel launches, not 1")
        m = pg.measure_traffic(cur_packed, tables, params_k, proj, acfg)
    return entries + [{  # the last batch is phase 9's largest
        "name": f"projective_gather_sum_K{tables.shape[0]}", "route": "cuda",
        "source": "g2o_frontend_tpu_torch/csrc/gather_probe.cu", "replaces": f"{pg.SCRIPT}:103",
        "launches": launches, "max_abs_err": 0.0, "ms": m["ms"], "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"], "bound_by": "bytes", "library_ms": None,
    }]


def tum_pose(p7):
    """4x4 pose of a TUM trajectory row (tx ty tz qx qy qz qw)."""
    import numpy as np

    x, y, z, w = p7[3:7] / np.linalg.norm(p7[3:7])
    T = np.eye(4)
    T[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    T[:3, 3] = p7[:3]
    return T


def cpu_copy(x):
    """A tensor, or a NamedTuple of tensors, copied to the CPU."""
    return type(x)(*(t.cpu() for t in x)) if isinstance(x, tuple) else x.cpu()


def median_ms(fn, runs=10):
    """Median per-run milliseconds of `fn` by CUDA events."""
    import numpy as np

    from g2o_frontend_tpu_torch.utils.profiling import event_ms

    return float(np.median(event_ms(fn, runs)))


def timed(fn):
    """(fn(), its milliseconds by one pair of CUDA events)."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def close(a, b, rtol=1e-5):
    """(a within `rtol` of b relative to b's largest magnitude, at least 1;
    the max abs difference) for two tensors on any devices. A float32 sum
    over N terms carries an error relative to the sum of the magnitudes,
    not to each component: a centroid's small x beside its 2.5 m z."""
    import torch

    a, b = a.cpu().double(), b.cpu().double()
    if not a.numel():
        return True, 0.0
    err = float((a - b).abs().max())
    return err <= rtol * max(1.0, float(b.abs().max())), err


def phase_conf_apps(ctx, out_dir):
    """Phase 11 (a): both command lines with the reference-format conf at
    scale 1 over the whole sequence, their kernel launches counted."""
    import numpy as np

    from g2o_frontend_tpu_torch.apps import pwn_odometry, pwn_slam
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa

    fa.launches, fa.batch_launches = 0, 0
    r = pwn_slam.run([SEQ, "--conf", CONF, "--device", "cuda", "--out-map", os.path.join(out_dir, "map_conf.npz"),
                      "--out-traj", os.path.join(out_dir, "slam_conf.txt")])
    k1, k2 = fa.launches, fa.batch_launches
    say("pwn", f"(a) pwn_slam --conf pwn_slam_tum.conf (scale 1, 640x480): frames {r['frames']}, keyframes "
        f"{r['keyframes']}, closures {r['closures']}, batches {r['batch_sizes']}, final chi2 {r['final_chi2']:.6g}, "
        f"ATE {r['ate']['rmse']:.4f} m, {r['frames_per_s']:.2f} frames/s; kernel-1 launches {k1}, kernel-2 launches "
        f"{k2} (phase 9's flag run: {ctx['app_launches'][0]} and {ctx['app_launches'][1]})")
    check(r["frames"] == 120 and np.isfinite(r["final_chi2"]) and np.isfinite(r["ate"]["rmse"]),
          "pwn_slam --conf run incomplete")
    check(k1 >= ctx["per_align"] * (r["frames"] - 1), f"pwn_slam --conf launched kernel 1 {k1} times")
    fa.launches = 0
    o = pwn_odometry.run([SEQ, "--conf", CONF, "--device", "cuda", "--out", os.path.join(out_dir, "odo_conf.txt")])
    say("pwn", f"(a) pwn_odometry --conf: frames {o['frames']}, keyframes {o['keyframes']}, ATE "
        f"{o['ate']['rmse']:.4f} m, {o['frames_per_s']:.2f} frames/s; kernel-1 launches {fa.launches}")
    check(o["frames"] == 120 and np.isfinite(o["ate"]["rmse"]), "pwn_odometry --conf run incomplete")
    check(fa.launches == ctx["per_align"] * (o["frames"] - 1), f"pwn_odometry --conf launched kernel 1 {fa.launches} "
          "times")


def phase_fusion(ctx):
    """Phase 11 (b) and (c): the map merger's cloud fusion over phase 9's
    map, each fusion held against the CPU on its inputs; then voxel
    downsampling of each fused cloud on the card and on the CPU."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.pwn.voxel import voxelize
    from g2o_frontend_tpu_torch.slam import map_merger

    tracker = ctx["slam"]["tracker"]
    mgr = tracker.manager
    # the gates: the JAX defaults, widened in proportion only if no accepted
    # closure falls within them
    scales = []
    for rel in mgr.relations:
        a, b = rel.node_from, rel.node_to
        if rel.is_closure and rel.accepted and a.level == b.level == 0:
            err = np.linalg.inv(a.transform) @ b.transform
            dr = float(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
            scales.append(max(float(np.linalg.norm(err[:3, 3])) / 0.25, dr / 0.25))
    check(scales, "no accepted closure in phase 9's map")
    widen = max(1.0, min(scales) * (1 + 1e-9))
    gates = (0.25 * widen, 0.25 * widen)
    calls, fuse = [], map_merger.fuse_clouds

    def recording(keep_c, drop_c, X, projector):
        out = fuse(keep_c, drop_c, X, projector)
        calls.append(((keep_c, drop_c, X, projector), out))
        return out

    map_merger.fuse_clouds = recording
    try:
        t0 = time.perf_counter()
        n_fused = map_merger.MapMerger(mgr, cloud_cache=tracker.cache).collapse_redundant(*gates)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        map_merger.fuse_clouds = fuse
    say("pwn", f"(b) MapMerger(cloud_cache=...).collapse_redundant over {len(ctx['slam']['nodes'])} keyframes, "
        f"gates {gates[0]:.6g} m / {gates[1]:.6g} rad ({'the JAX defaults' if widen == 1.0 else 'widened'}; "
        f"{sum(s <= 1 for s in scales)} of {len(scales)} accepted closures within the defaults): {n_fused} pairs "
        f"fused in {secs:.3f} s")
    check(n_fused >= 1 and len(calls) == n_fused, f"{n_fused} pairs fused, {len(calls)} fusions recorded")

    worst_share, fusion_ms, voxel_ms = 0.0, [], {0.02: [], 0.1: []}
    for i, (args, (depth, fused)) in enumerate(calls):
        keep_c, drop_c, X, proj = args
        n_pix = proj.rows * proj.cols
        check(fused.capacity == 2 * n_pix, f"fusion {i}: a {fused.capacity}-slot model")
        before, after = int(keep_c.valid.sum()) + int(drop_c.valid.sum()), int(fused.mask.sum())
        fusion_ms.append(median_ms(lambda: fuse(*args)))
        depth_c, fused_c = fuse(cpu_copy(keep_c), cpu_copy(drop_c), X.cpu(), proj)
        differ = int((fused.mask.cpu() != fused_c.mask).sum())
        worst_share = max(worst_share, differ / before)
        both = fused.mask.cpu() & fused_c.mask
        same_w = both & (fused.weights.cpu() == fused_c.weights)
        pts_ok, pts_err = close(fused.points.cpu()[same_w], fused_c.points[same_w])
        hit = (depth.cpu() > 0) & (depth_c > 0)
        _, depth_err = close(depth.cpu()[hit], depth_c[hit])
        changed = int(((depth - keep_c.p[2]).abs() > 1e-6)[keep_c.valid & (depth > 0)].sum())
        say("pwn", f"(b) fusion {i}: {fused.capacity} slots, points {before} -> {after}, {fusion_ms[-1]:.3f} ms; "
            f"survivor depth changed at {changed} pixels; against the CPU: {differ} collapse decisions differ "
            f"({differ / before:.2e} of the points), weights differ at {int((both & ~same_w).sum())} survivors, "
            f"points where weights agree within {pts_err:.3e}, depth where both hit within {depth_err:.3e}")
        check(after < before and changed > 0, f"fusion {i} fused nothing")
        check(differ / before < 1e-3 and int((both & ~same_w).sum()) <= differ, f"fusion {i}: decisions differ")
        check(pts_ok, f"fusion {i}: points differ from the CPU by {pts_err}")
        # (c) voxel downsampling of the fused cloud
        for res in voxel_ms:
            c, n, occ = voxelize(fused.points, fused.mask, res, 1 << 16)
            voxel_ms[res].append(median_ms(lambda: voxelize(fused.points, fused.mask, res, 1 << 16)))
            cc, nc, occ_c = voxelize(fused.points.cpu(), fused.mask.cpu(), res, 1 << 16)
            c_ok, c_err = close(c[occ], cc[occ_c])
            say("pwn", f"(c) fusion {i} at {res} m: {int(occ.sum())} voxels occupied of {1 << 16}, "
                f"{voxel_ms[res][-1]:.3f} ms; against the CPU: occupancy and counts "
                f"{'equal' if torch.equal(occ.cpu(), occ_c) and torch.equal(n.cpu(), nc) else 'DIFFER'}, centroids "
                f"within {c_err:.3e}")
            check(torch.equal(occ.cpu(), occ_c) and torch.equal(n.cpu(), nc) and c_ok,
                  f"voxels of fusion {i} at {res} m differ from the CPU")
    say("timing", f"(b) fusion of a pair (2 x {n_pix} slots), CUDA events, median per pair: "
        f"{np.median(fusion_ms):.3f} ms (min {min(fusion_ms):.3f}, max {max(fusion_ms):.3f}); worst share of "
        f"collapse decisions differing from the CPU {worst_share:.2e}; (c) voxelize median "
        + ", ".join(f"{res} m {np.median(v):.3f} ms" for res, v in voxel_ms.items()))


def phase_planes(ctx):
    """Phase 11 (d): plane extraction on the bench pair and five TUM frames
    at 640x480, and the depth calibration over those frames, each against
    the CPU on the same inputs."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import pwn_odometry
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.pwn.calibration import DepthCalibration
    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud
    from g2o_frontend_tpu_torch.pwn.planes import extract_planes

    proj, ccfg, _ = pwn_odometry.configs(1, "kinect")
    index = tum.read_depth_index(SEQ)
    depths = [torch.as_tensor(tum.load_depth_png(os.path.join(SEQ, index[k][1])), device=ctx["device"])
              for k in (0, 24, 48, 72, 96)]
    clouds = [("bench ref", ctx["ref"]), ("bench cur", ctx["cur"])] + [
        (f"TUM frame {k}", depth_to_cloud(d, proj, ccfg)) for k, d in zip((0, 24, 48, 72, 96), depths)]
    times = []
    for name, cloud in clouds:
        ps = extract_planes(cloud)
        times.append(median_ms(lambda: extract_planes(cloud)))
        pc = extract_planes(cpu_copy(cloud))
        same = torch.equal(ps.mask.cpu(), pc.mask) and torch.equal(ps.n_inliers.cpu(), pc.n_inliers)
        # centroids within 1e-5; a refit's normal and d within 1e-4: the
        # card sums the inliers' covariance in another float32 order, and a
        # plane of a few thousand inliers turns by ~1e-5 (TUM frame 96)
        errs = [close(getattr(ps, f), getattr(pc, f), rtol) for f, rtol in (("normal", 1e-4), ("d", 1e-4),
                                                                            ("centroid", 1e-5))]
        say("pwn", f"(d) extract_planes, {name}: {int(ps.mask.sum())} planes, inliers "
            f"{[int(x) for x in ps.n_inliers[ps.mask].cpu()]}, {times[-1]:.3f} ms; against the CPU: mask and inliers "
            f"{'equal' if same else 'DIFFER'}, normal / d / centroid within "
            + " / ".join(f"{e:.2e}" for _, e in errs))
        check(same and all(ok for ok, _ in errs), f"planes of {name} differ from the CPU")
        check(int(ps.mask.sum()) >= 1, f"no plane in {name}")
    cal, cal_c = DepthCalibration(proj, device=ctx["device"]), DepthCalibration(proj, device="cpu")
    cal_ms, fractions = [], []
    for d in depths:
        fraction, ms = timed(lambda: cal.add_frame(d))
        fractions.append(fraction)
        cal_ms.append(ms)
        fc = cal_c.add_frame(d.cpu())
        check(abs(fractions[-1] - fc) < 1e-4, f"calibration fraction {fractions[-1]} vs the CPU's {fc}")
    # each device converts the frames itself, so a pixel at the 10% gate
    # may fall on either side: count the pixels beyond 1e-5
    img, img_c = cal.calibration_image.cpu(), cal_c.calibration_image
    beyond = int(((img - img_c).abs() > 1e-5).sum())
    say("pwn", f"(d) DepthCalibration.add_frame over the five TUM frames: contributing fractions "
        f"{[round(f, 4) for f in fractions]}, {np.median(cal_ms):.3f} ms median (CUDA events, one call each); "
        f"calibration image against the CPU's: {beyond} of {img.numel()} pixels beyond 1e-5, max abs difference "
        f"{float((img - img_c).abs().max()):.2e}; multipliers {float(img.min()):.4f}-{float(img.max()):.4f}")
    check(beyond <= 1e-3 * img.numel() and bool(torch.isfinite(img).all()), "calibration image differs from the CPU")
    say("timing", f"(d) extract_planes at 640x480, CUDA events, median of 10 runs per cloud: "
        f"{np.median(times):.3f} ms (min {min(times):.3f}, max {max(times):.3f})")


def phase_manifold(ctx):
    """Phase 11 (e): the manifold Voronoi extractor over the last 30
    keyframes of phase 9's map and the diagram, against the CPU."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.slam import manifold_voronoi as mv

    tracker = ctx["slam"]["tracker"]
    nodes = [n for n in ctx["slam"]["nodes"] if n.level == 0][-30:]
    # the grid is top-down in the key node's frame, z up: the clouds and
    # poses go from the camera's optical frame (z forward, y down) to the
    # body frame of a robot carrying it (x forward, z up). A cell keeps its
    # highest point, so the room's ceiling (0.8 m above the camera) would
    # cover every cell: points over 0.5 m are masked out
    T_bc = np.zeros((4, 4))
    T_bc[0, 2], T_bc[1, 0], T_bc[2, 1], T_bc[3, 3] = 1.0, -1.0, -1.0, 1.0
    T_bc_dev = torch.as_tensor(T_bc, dtype=torch.float32, device=ctx["device"])
    ex, ex_c = mv.ManifoldVoronoiExtractor(), mv.ManifoldVoronoiExtractor()
    for n in nodes:
        cloud = tracker.cache.get(n.payload["frame"]).transform(T_bc_dev)
        cloud = cloud._replace(valid=cloud.valid & (cloud.p[2] < 0.5))
        pose = n.transform @ np.linalg.inv(T_bc)
        ex.add_keyframe(n.seq, cloud, pose)
        ex_c.add_keyframe(n.seq, cloud._replace(p=cloud.p.cpu(), n=cloud.n.cpu(), valid=cloud.valid.cpu()), pose)
    grids, grid = [], mv.manifold_grid

    def recording(*args, **kw):
        grids.append((args, kw))
        return grid(*args, **kw)

    mv.manifold_grid = recording
    try:
        data = ex.extract()
    finally:
        mv.manifold_grid = grid
    (pts, nrm, val), kw = grids[0]
    n_points = int(val.numel())
    extract_ms = median_ms(ex.extract, 5)
    grid_ms = median_ms(lambda: grid(pts, nrm, val, **kw), 5)
    dist, edges, skel = mv.manifold_diagram(data.obstacle)
    diagram_ms = median_ms(lambda: mv.manifold_diagram(data.obstacle), 5)
    h_c, o_c = grid(pts.cpu(), nrm.cpu(), val.cpu(), **kw)
    grid_same = torch.equal(data.height.cpu(), h_c) and torch.equal(data.obstacle.cpu(), o_c)
    data_c = ex_c.extract()
    cells_differ = int((data.height.cpu() != data_c.height).sum() + (data.obstacle.cpu() != data_c.obstacle).sum())
    dist_c, edges_c, skel_c = mv.manifold_diagram(data.obstacle.cpu())
    finite = torch.isfinite(dist_c)
    dist_err = float((dist.cpu()[finite] - dist_c[finite]).abs().max()) if bool(finite.any()) else 0.0
    edges_differ, skel_differ = int((edges.cpu() != edges_c).sum()), int((skel.cpu() != skel_c).sum())
    # distances are square roots of integer sums of squares: equal up to
    # the rounding of the square root
    diagram_same = (torch.equal(torch.isfinite(dist).cpu(), finite) and dist_err <= 1e-6 * float(dist_c[finite].max())
                    and edges_differ == skel_differ == 0)
    cfg = ex.config
    say("pwn", f"(e) manifold Voronoi over the last {len(nodes)} keyframes (body frame, z up): {n_points} points into the "
        f"{cfg.x_size}x{cfg.y_size} grid at {cfg.resolution} m: {int(data.obstacle.sum())} obstacle cells, "
        f"{int((data.height < mv._FREE_INIT).sum())} cells seen, {int(edges.sum())} Voronoi edge cells, "
        f"{int(skel.sum())} skeleton cells; extract {extract_ms:.3f} ms, manifold_grid {grid_ms:.3f} ms, "
        f"diagram {diagram_ms:.3f} ms (CUDA events, median of 5); against the CPU: manifold_grid on the same points "
        f"{'equal' if grid_same else 'DIFFERS'}, the CPU's own extract differs at {cells_differ} cells; the diagram "
        f"on the same grid: distances within {dist_err:.3e}, edges differ at {edges_differ} cells, the skeleton at "
        f"{skel_differ}")
    check(n_points == len(nodes) * 480 * 640, f"{n_points} points into the grid")
    check(grid_same and diagram_same, "the manifold grid or diagram differs from the CPU")
    check(cells_differ <= 0.01 * cfg.x_size * cfg.y_size, f"the CPU's extract differs at {cells_differ} cells")
    check(int(data.obstacle.sum()) > 0 and int(edges.sum()) > 0, "an empty manifold grid or diagram")


def phase_cloud_io(ctx, out_dir):
    """Phase 11 (f): a 640x480 cloud through a `.pwn` file and back, and the
    cloud_aligner command line on two TUM frames."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import cloud_aligner
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.pwn import cloud_io

    ref = ctx["ref"]
    path, again = os.path.join(out_dir, "ref.pwn"), os.path.join(out_dir, "ref_again.pwn")
    cloud_io.save_pwn(path, ref, T=ctx["T_gt"])
    d = cloud_io.load_pwn(path)
    valid = ref.valid.reshape(-1).cpu().numpy()
    bit_equal = all(np.array_equal(d[k].view(np.uint32), getattr(ref, f).reshape(c, -1).T.cpu().numpy()[valid]
                                   .reshape(d[k].shape).view(np.uint32))
                    for k, f, c in (("points", "p", 3), ("normals", "n", 3), ("eigenvalues", "ev", 3),
                                    ("curvature", "curv", 1)))
    back = cloud_io.cloud_from_pwn(path, device=ctx["device"])
    cloud_io.save_pwn(again, back, T=ctx["T_gt"])
    with open(path, "rb") as first, open(again, "rb") as second:
        same_bytes = first.read() == second.read()
    say("pwn", f"(f) .pwn round trip of the bench reference cloud: {len(d['points'])} points, "
        f"{os.path.getsize(path)} bytes; fields bit-equal: {bit_equal}; re-saved from cloud_from_pwn byte-equal: "
        f"{same_bytes}")
    check(bit_equal and same_bytes, "the .pwn round trip is not bit-equal")
    index = tum.read_depth_index(SEQ)
    r = cloud_aligner.run([os.path.join(SEQ, index[0][1]), os.path.join(SEQ, index[3][1]), "--device", "cuda"])
    T = np.asarray(r["transform"])
    _, gt = tum.read_trajectory(os.path.join(SEQ, "groundtruth.txt"))
    T_gt = np.linalg.inv(tum_pose(gt[0])) @ tum_pose(gt[3])
    t_err = float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))
    say("pwn", f"(f) cloud_aligner on TUM frames 0 and 3 at 640x480: inliers {r['inliers']}, chi2 {r['chi2']:.6g}, "
        f"|t| {float(np.linalg.norm(T[:3, 3])):.4f} m, t_err against the ground truth {t_err:.3e} m, "
        f"valid {r['valid']}")
    check(np.isfinite(T).all() and r["valid"] and t_err < 0.01, f"cloud_aligner t_err {t_err} m")


def run(out_dir):
    import numpy as np
    import torch

    import g2o_frontend_tpu_torch  # noqa: F401  (turns TF32 off)
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig
    from g2o_frontend_tpu_torch.pwn.converter import ConverterConfig, depth_to_cloud
    from g2o_frontend_tpu_torch.utils.profiling import gpu_name_and_power_limit
    from g2o_frontend_tpu_torch.utils.synth import bench_pair

    # 1. device
    smi = gpu_name_and_power_limit()
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
    k2_launches, err2, k2_ms, k2_previous_ms, k2_plain_ms, k2_bound = phase_slam(ctx, out_dir)  # 9
    gather_entries = phase_gather(ctx)  # 10
    t11 = time.perf_counter()  # 11
    phase_conf_apps(ctx, out_dir)
    phase_fusion(ctx)
    phase_planes(ctx)
    phase_manifold(ctx)
    phase_cloud_io(ctx, out_dir)
    say("pwn", f"phase 11 took {time.perf_counter() - t11:.1f} s")

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
    kernels[1]["previous_ms"] = k2_previous_ms  # the previous batch design, in the same turns
    kernels += gather_entries
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
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
    from g2o_frontend_tpu_torch.utils.profiling import CheckFailure

    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            kind, count = run(out_dir)
    except CheckFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    say("done", f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
