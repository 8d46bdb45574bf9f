#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: PWN dense RGB-D odometry (slice 1),
PWN SLAM with loop closing (slice 2), the gather probes, the rest of PWN,
the 2D pose-graph backend (slice 3), 2D SLAM with unknown data
association (slice 4), laser grid SLAM, line SLAM, the plane graph and BA
(slice 5), the distributed solvers (slice 6) and the system's own entry
points (the flagship step, the multi-device dry run, the bench and the
dataset-free evaluation protocols).

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA; JAX is not needed:

    python3 chip_smoke.py

Phases, one line each or more, any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/fused_aligner.cu, csrc/linearizer.cu,
     csrc/gather_probe.cu and csrc/segment_sum.cu from the checkout, all at
     once, and prints each kernel's registers, stack and spills and the
     segment-sum kernel's shared memory a block at the main path's shapes;
  3. kernel 1 (one aligner system) against its plain PyTorch version on the
     640x480 bench pair at three poses (identity, ground truth, a 5 cm /
     3 deg perturbation), and once more with the non-robust chi2 gate;
  4. align at 640x480 with the default configs: t_err gate, kernel-1
     launches and Gauss-Newton steps counted;
     depth_to_cloud's and align's CUDA graphs (utils/graphs.py, all three
     associations) bit-equal to their eager bodies, and timed against them
     in turns by CUDA events around whole calls, with device times
     (torch.profiler) and the device's idle share; the kernel and its
     plain version; the Gauss-Newton step kernel on kernel 1's block rows
     at the bench pose (tools/gn_step_probe.py) against the plain tail,
     two launches bit-equal, timed against the plain reduction and tail;
  5. the tracker command line over the bundled 120-frame TUM sequence at
     scale 2 (ATE gate, per-frame and --scan modes), odometry_scan's graphs
     bit-equal to its eager bodies on the --scan inputs, and, as slice 1's
     main-path run whose kernel launches and steps are counted, at scale 1 (640x480),
     its trajectory and per-frame figures bit-equal to a rerun with the
     tracker's stages eager (its keyframe map is phase 9's);
  6. kernel 2 (K candidate systems, the tiled design) at 640x480, K = 8
     reference clouds rendered around the identity against one current
     cloud: against its plain version, against 8 kernel-1 calls and against
     the previous batch design, two launches bit-equal, and timed in turns
     with the previous design;
  7. align_batch at 640x480, K = 8, against 8 serial align calls: T, inliers,
     launch counts, and the times of both; its graph bit-equal to its eager
     body and timed against it in turns;
  8. kernel 3 (the z-buffer linearizer) against its plain version on the
     z-buffer association of the bench pair, then align with
     association="zbuffer" at 640x480 (t_err gate, its launches counted);
  9. PWN SLAM at 640x480 over the bundled sequence (the app's own closer
     radius), then slice 2's main-path run: the loop closer with a 1 m
     radius over phase 5's scale-1 keyframe map and the hierarchical
     pose-graph solve, whose kernel-2 launches are counted; every
     align_batch call of the closer recorded and run again on the eager
     body, bit-equal to the graph, recording the inputs of each kernel-2
     launch; kernel 2 against its plain version on the inputs of every one
     of those launches (two launches bit-equal), timed in turns with the
     previous batch design at each K of the run; align_batch's graph
     against its eager body at the largest K; and the app's synthetic
     40-frame orbit;
 10. the gather probes of apps/profile_gather.py: the TPU script's four
     probes at its shapes beside the launch floor (a one-element add_ timed
     as they are), each kernel bit-equal to its plain version (NaN in
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
     cloud_aligner command line on two TUM frames;
 12. the 2D pose-graph backend (plain PyTorch and cuSOLVER; every sum by
     the segment-sum kernel, its launches counted on the Schur solve) at
     victoriaPark's counts, a simulated world of 7,120 poses and 151
     landmarks (21,662 DOF): (a) the world through write_g2o and back,
     the native parser (g++ build from the checkout) equal to the Python
     one; (b) optimize_se2_schur and optimize_se2_direct each within 1.01x
     the float64 host control, the Schur run repeated on the CPU in a
     worker process while the card goes on (traces within rtol 1e-3; the
     same worker then runs phase 14's CPU runs), the dense solve against its CPU run on a 1,000-pose
     world; (c) the pose-only world through optimize_se2 with both
     preconditioners against the CPU; (d) landmark_covariance_se2 against
     the CPU and graph_optimizer --device cuda on the file, equal to a
     direct optimize_se2 call; (e) optimize_se3
     (chain) on bench.py's 300-pose world and on the default 2,000-pose
     world against the float64 control, and graph_optimizer on an SE3
     file. Each solver of (b), (c) and (e) runs as utils/graphs.solve_loop
     runs it (graphs on the card) twice and in "eager" mode once, all bit
     for bit the same (`graphed_solve`): the whole solve graph against
     eager in turns by CUDA events, LM and CG iterations, host reads a
     solve, the device ms, device operations and busy share of one graphed
     LM iteration under torch.profiler, each captured piece's ms and pool
     bytes; the covariance stage against its eager mode. Phases 9, 13, 14
     and 16 record every call of the public solvers (`SolverCalls`), rerun
     them in eager mode for up to 10 s, bit for bit the same, and print the
     two times and the captures;
 13. slice 4 (no kernel) at world-2000's counts, a simulated world of 2,001
     poses and 70 landmarks written as a noassoc log: (a) `tracker2d
     --device cuda` with the world2000 flags, then a `models.build(
     "tracker2d", recipe="world2000")` tracker over the log (frames/s)
     and EVAL.md section 2's closing schedule, gated on ATE < 0.7x the
     odometry's and on the landmark count (0.6-1.8x those seen), with the
     ATE against the known-association float64 optimum; the solve chains
     and stage keys captured over these runs (the graphs are padded to the
     JAX package's capacity buckets) and the pool bytes; the tracker and
     schedule again with every stage and solve in eager mode, bit for bit
     the same, frames/s graphed against eager; (b) 300 frames on
     the card and on the CPU in lockstep, the associations equal up to the
     first window solve, then the card's device operations, host syncs
     and busy share of a frame and of a window solve under
     torch.profiler; (c) validated tracking, the constellation closure,
     graph merge and every model family at test size;
 14. slice 5 at full size: (a) `models.build("grid_slam")` over
     a simulated laser world at graphSE2.g2o's 452 scans (800x800 grids at
     0.05 m) and its pose-graph solve, its ATE against the odometry's;
     every correlative match of the card rerun on the CPU (>= 99% the
     CPU's pose, the rest ties); the same scans through the port on the
     CPU in the worker (the same submap count); the JAX package's 120-scan ground-truth
     fixture, gated on ATE < 0.75x the odometry's and < 0.35 m; 20 scans
     under torch.profiler; (b) `models.build("line_slam")` over the same
     scans twice on the card graphed and once in eager mode (lines,
     observations and poses bit-equal, scans/s graphed against eager, the
     segment-sum kernel's launches counted through replays) and on the CPU
     in the worker, the card's line count and ATE in bands around the CPU's
     run and the JAX package's recorded one; every scan's graphed
     `extract_lines` bit-equal to its eager body, one scan timed graph
     against eager; the last line-graph solve, (c) the plane graph at 1,000
     poses and 60 planes and (d) BA at 200 poses and 20,000 points, each
     padded to the JAX package's capacities and run as phase 12 runs its
     solves (graphed twice and eager once, bit for bit, whole solves in
     turns by CUDA events, host reads a solve, captures), each trace's
     first LM iterations within rtol 1e-3 of the CPU's, and a 30-pose BA
     within 1.01x the float64 control;
     (e) the segment-sum kernel against its plain version on every
     distinct sum of every path that launches it: one LM iteration of
     phase 12's Schur solve and of (d)'s BA, one line-SLAM extraction and
     solve of (b), one fusion of phase 11 (b) and its voxels at 0.02 and
     0.1 m, and one of the Schur sums as float64: bit-equal to the CPU's
     index_add_ and to the previous design, two launches bit-equal, timed
     in turns with the previous design and the atomic index_add_, beside
     its bound, its longest segment and its path's launches;
 15. slice 6, the distributed solvers on 8 shards stacked on
     the card (StackedMesh), each step also on the CPU: (a) the halo
     exchange in both wire modes and SPIKE at test size against dense
     oracles; (b) optimize_se2_partitioned (jacobi, chain) and
     optimize_se2_schur_partitioned on phase 12's 21,662-DOF world, the
     jacobi trace against the single-device solver, the Schur one within
     1.01x the float64 control, with the communication volume; (c) the
     SE3 SPIKE solve on the 300-pose world within 1.01x its control; (d)
     the edge-sharded SE2, SE3 (2,000 poses) and BA (160,000
     observations) solvers against the single-device ones; (e) every
     solver of (b)-(d) on a ProcessMesh over NCCL at world size 1 against
     StackedMesh(1); (f) graph_optimizer --devices 8, equal to (d)'s SE2
     run. Each solver of (b)-(d) runs again on the card for its first LM
     iterations, its trace bit-equal to the first run's prefix. Each
     solve prints its LM iterations/s, the busy share of one LM iteration
     and the operations of one CG iteration;
 16. the system's own entry points (kernels 1 and 2 on their paths, each
     path's launches counted from 0): (a) `entry.entry()` on the card
     against its stages' eager bodies (bit for bit) and against the CPU,
     the whole step and the align on the card's clouds,
     entry() and depth_to_cloud on the 640x480 bench image each twice, bit
     for bit the same, and `entry.dryrun_multichip(8)` with its asserts; (b) the bench
     (`apps/bench.run(["--no-cpu-control"])`, its JSON line and asserts:
     tracker slower than align, t_err < 1 cm, the SE3 world at D = 8
     within 1.01x its control) and one CPU run of its aligner section for
     vs_baseline; (c) the four dataset-free EVAL sections of
     `apps/evaluate.py` at full size, each JSON line with its wall time:
     grid_slam_gt (ATE < 0.75x the odometry's), pwn_odometry_tum (14
     columns a row, ATE < 0.5 m), pwn_slam (finite chi2) and the 500-frame
     stress run without the cloud cache, gated against the JAX package's
     CPU run (keyframes within 15%, closures >= 0.8x, no fallback,
     evictions, keyframe ATE <= 1.25x and < 0.5 m), then with it.
Every kernel's device time, and its plain version's, is the slope of CUDA
graph replays timed by CUDA events (utils/profiling.graph_ms), in the phase
that checks the kernel. Each key a stage captures gets a line (capture ms,
pool bytes), each phase its seconds. Then the graph-against-eager summary,
one JSON line of the kernels, the card's name and power limit, and a last
JSON line with the device.
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
    types = {"f": "float", "d": "double"}
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?(?<!\d)\d+([a-z][a-z_]*_kernel)(?:I([fd])(?:Li(\d+)E)?E)?",
                          ln)
        if entry:
            name, ty, num = entry.groups()
            args = [a for a in (types.get(ty), num) if a]
            kernels.append((name + (f"<{', '.join(args)}>" if args else ""), []))
        elif "registers" in ln or "spill" in ln:
            kernels[-1][1].append(ln.replace("ptxas info    :", "").strip())
    return [k for k in kernels if k[1]]


def build_kernels():
    """Phase 2: one nvcc per CUDA source, all started together."""
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.ops import gather_probe as gp
    from g2o_frontend_tpu_torch.ops import linearizer as lin
    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    t0 = time.perf_counter()
    modules = (fa, lin, gp, ss)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = [(mod, pool.submit(mod.build)) for mod in modules]
        for mod, fut in builds:
            lib, secs, log = fut.result()
            say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s")
            for name, lines in ptxas_lines(log):
                say("build", f"  {name}: " + " | ".join(lines))
    say("build", f"{len(modules)} sources built in {time.perf_counter() - t0:.1f} s of wall time")
    shapes = ((160000, 200, 36, 4, "BA cameras"), (160000, 200, 6, 4, "BA camera vectors"),
              (20803, 7120 * 151, 6, 4, "the Schur arrow"),
              (614400, 614400, 4, 4, "a fusion"), (3000, 151, 3, 8, "float64, C = 3"))
    say("build", "  segment_sum_kernel's dynamic shared memory a block (ops/segment_sum.layout): " + "; ".join(
        f"{label} {ss.layout(E, n, C, w).smem} B" for E, n, C, w, label in shapes))


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
    """Phase 4: align at 640x480 and the times of kernel 1; depth_to_cloud's
    and align's graphs bit-equal to their eager bodies, and timed against
    them in turns."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn import aligner as al
    from g2o_frontend_tpu_torch.pwn import converter as cv
    from g2o_frontend_tpu_torch.pwn.aligner import align
    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud
    from g2o_frontend_tpu_torch.apps.profile_gather import system_bytes
    from g2o_frontend_tpu_torch.utils.profiling import bound, device_ms, graph_ms
    from tools.graph_probe import same_bits as same_tree

    acfg, proj, ref, cur = ctx["acfg"], ctx["proj"], ctx["ref"], ctx["cur"]
    before, before_steps = fa.launches, fa.step_launches
    res = align(ref, cur, proj, config=acfg)
    torch.cuda.synchronize()
    grew, steps = fa.launches - before, fa.step_launches - before_steps
    t_err = float(np.linalg.norm((ctx["inv_gt"] @ res.T.double().cpu().numpy())[:3, 3]))
    say("align", f"t_err {t_err:.3e} m; inliers {int(res.inliers)} (JAX bench record {BENCH_INLIERS}); "
        f"valid {bool(res.valid)}; kernel launches +{grew}, Gauss-Newton steps +{steps}")
    per_align, steps_per_align = ctx["per_align"], ctx["steps_per_align"]
    check(grew == per_align, f"launches grew by {grew}, not {per_align}")
    check(steps == steps_per_align, f"Gauss-Newton steps grew by {steps}, not {steps_per_align}")
    check(t_err < 0.01, f"t_err {t_err} >= 0.01 m")
    check(all(bool(torch.isfinite(x).all()) for x in (res.T, res.omega, res.mean)), "non-finite align result")
    for association in ("fused", "gather"):  # one kernel path for all three names
        before, before_steps = fa.launches, fa.step_launches
        other = align(ref, cur, proj, config=dataclasses.replace(acfg, association=association))
        check(fa.launches - before == per_align and fa.step_launches - before_steps == steps_per_align
              and torch.equal(other.T, res.T), f"association={association!r} did not run the same kernel path")
    say("align", f"association 'fused' and 'gather' launch the kernel {per_align} times and give the same T")
    # each graph against its eager body on the same inputs, bit for bit
    d_cur, ccfg = ctx["d_cur"], ctx["ccfg"]
    check(same_tree(depth_to_cloud(d_cur, proj, ccfg), cv._depth_to_cloud(d_cur, proj, ccfg, None)),
          "depth_to_cloud's graph differs from its eager body")
    for association in ("auto", "gather", "zbuffer"):
        cfg = dataclasses.replace(acfg, association=association)
        check(same_tree(align(ref, cur, proj, config=cfg), al._align(ref, cur, proj, None, cfg, None)),
              f"align's graph (association {association!r}) differs from its eager body")
    say("graphs", "depth_to_cloud and align (associations 'auto', 'gather', 'zbuffer') on the bench pair: each "
        "graph's outputs bit-equal to its eager body's")
    graph_turns(ctx, f"depth_to_cloud {proj.rows}x{proj.cols}", lambda: depth_to_cloud(d_cur, proj, ccfg),
                lambda: cv._depth_to_cloud(d_cur, proj, ccfg, None), 30)
    graph_turns(ctx, f"align {proj.rows}x{proj.cols}", lambda: align(ref, cur, proj, config=acfg),
                lambda: al._align(ref, cur, proj, None, acfg, None), 30)
    params = fa.params_from_invT(torch.as_tensor(ctx["inv_gt"], dtype=torch.float32, device=ctx["device"]))

    def kernel():
        return fa.fused_system(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)

    def plain():
        return fa.fused_system_reference(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)

    kernel_ms, plain_ms = graph_ms(kernel, params, 50), graph_ms(plain, params, 20)
    say("timing", f"one system at 640x480, device ms per call by CUDA graph replays: kernel {kernel_ms:.6f}, plain "
        f"{plain_ms:.6f}; by torch.profiler: kernel {device_ms(kernel, 50):.6f}")
    ctx["captures"] = report_captures("graphs", ctx.get("captures", 0))
    n_bytes = system_bytes(ctx["cur_packed"], params, proj, fa.N_SUMS)
    return kernel_ms, plain_ms, bound(n_bytes, proj.rows * proj.cols * OPS_PER_PIXEL_SYSTEM), step_kernel_check(ctx)


def step_kernel_check(ctx):
    """The Gauss-Newton step kernel on kernel 1's 640x480 block rows at the
    bench pose, with and without the re-orthonormalisation: its sums
    bit-equal to `fused_system`'s, invT and params within 2e-6 (relative,
    of the norm) of the plain tail (`fused_aligner.step_reference`), two
    launches bit-equal. Timed against the plain version (the rows reduced
    in float64, then the plain tail), beside the bound of the bytes it
    reads and writes. Returns (max abs err of invT and params, ms, plain
    ms, (bound ms, bound by))."""
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.utils.profiling import bound, graph_ms
    from tools import gn_step_probe

    acfg, proj = ctx["acfg"], ctx["proj"]
    invT = torch.as_tensor(ctx["inv_gt"], dtype=torch.float32, device=ctx["device"])
    params = fa.params_from_invT(invT)
    rows, sums = gn_step_probe.block_rows(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)
    check(torch.equal(sums, fa.fused_system(ctx["cur_packed"], ctx["ref_table"], params, proj, acfg)),
          "kernel 1's block rows reduce to other sums than fused_system's")
    err, rel = 0.0, 0.0
    for reorthonormalize in (False, True):
        got = gn_step_probe.step_kernel(rows, invT, acfg.damping, reorthonormalize)
        again = gn_step_probe.step_kernel(rows, invT, acfg.damping, reorthonormalize)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), "two launches of the step kernel differ")
        k_invT, k_params, _, k_sums = got
        check(torch.equal(k_sums, sums), "the step kernel's sums differ from fused_system's")
        for k, p in zip((k_invT, k_params), fa.step_reference(sums, invT, acfg.damping, reorthonormalize)):
            k, p = k.double(), p.double()
            err = max(err, float((k - p).abs().max()))
            rel = max(rel, float(torch.linalg.norm(k - p) / torch.linalg.norm(p)))
    check(rel < 2e-6, f"the step kernel's invT or params differ from the plain tail's by {rel:.3e} (relative)")

    def kernel():
        return gn_step_probe.step_kernel(rows, invT, acfg.damping, True)

    def plain():
        return fa.step_reference(rows.sum(0, dtype=torch.float64).float(), invT, acfg.damping, True)

    kernel_ms, plain_ms = graph_ms(kernel, rows, 50), graph_ms(plain, rows, 20)
    # the block rows read; invT read, the 75-float state written
    n_bytes = rows.numel() * 4 + 16 * 4 + fa.N_STATE * 4
    bound_ms, bound_by = bound(n_bytes, rows.numel())
    say("step", f"Gauss-Newton step kernel on kernel 1's {rows.shape[0]} block rows at 640x480: sums bit-equal to "
        f"fused_system's, two launches bit-equal, invT and params within {rel:.3e} (relative; {err:.3e} abs) of "
        f"the plain tail; device ms per call by CUDA graph replays: kernel {kernel_ms:.6f}, plain {plain_ms:.6f}; "
        f"bound {bound_ms:.6f} ({bound_by}, {n_bytes} B, {100 * bound_ms / kernel_ms:.1f}% of it)")
    return err, kernel_ms, plain_ms, (bound_ms, bound_by)


def phase_tracker(ctx, out_dir):
    """Phase 5: the tracker command line; returns the main-path launches
    of kernel 1 and of the step kernel.
    The --scan inputs at scale 2 through odometry_scan's graphs and through
    its eager bodies, bit for bit; the scale-1 run's trajectory and
    per-frame figures against a rerun with the tracker's stages eager, bit
    for bit. Keeps the scale-1 tracker (its keyframe map) in
    ctx["tracker_s1"] for phase 9."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import pwn_odometry
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn import aligner as al
    from g2o_frontend_tpu_torch.pwn import converter as cv
    from g2o_frontend_tpu_torch.slam import pwn_tracker as pt
    from tools.graph_probe import eager_scan, same_bits as same_tree

    per_align = ctx["per_align"]
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

    # --scan's inputs through the graphs and through the eager bodies
    proj2, ccfg2, acfg2 = pwn_odometry.configs(2, "kinect")
    raw = np.stack([tum.load_depth_png_raw(os.path.join(SEQ, rel))[::2, ::2] for _, rel in tum.read_depth_index(SEQ)])
    depths = pt._depth_batch(raw, ctx["device"], 1.0 / 5000.0)
    min_inliers = max(50, int(3000 * (proj2.rows * proj2.cols) / (480 * 640)))
    scan_args = (proj2, ccfg2, acfg2, 0.75, min_inliers)
    graphed, g_ms = timed(lambda: pt.odometry_scan(depths, *scan_args[:3], kf_fraction=0.75,
                                                   min_cloud_inliers=min_inliers, device=ctx["device"]))
    eager, e_ms = timed(lambda: eager_scan(depths, *scan_args))
    check(same_tree(graphed, eager), "odometry_scan's graphs differ from its eager bodies on the --scan inputs")
    say("graphs", f"odometry_scan over the 120 frames at scale 2: trajectory and metrics bit-equal to the eager "
        f"bodies'; {len(depths) / g_ms * 1e3:.2f} frames/s by the graphs, {len(depths) / e_ms * 1e3:.2f} eager "
        "(CUDA events around the call)")

    def scale1(tag):
        """The scale-1 command line; (its result, its tracker)."""
        made = []

        class Kept(pt.PwnTracker):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        pwn_odometry.PwnTracker = Kept
        try:
            r = pwn_odometry.run([SEQ, "--device", "cuda", "--scale", "1", "--kf-fraction", "0.75",
                                  "--out", os.path.join(out_dir, f"traj_s1{tag}.txt")])
        finally:
            pwn_odometry.PwnTracker = pt.PwnTracker
        return r, made[0]

    fa.launches = fa.step_launches = 0  # slice 1's main-path run: count the launches of this run only
    s1, tracker = scale1("")
    main_launches, main_steps = fa.launches, fa.step_launches
    ate1 = s1["ate"]["rmse"]
    say("tracker", f"scale 1 (640x480): ATE {ate1:.4f} m; keyframes {s1['keyframes']}/{s1['frames']}; "
        f"{s1['frames_per_s']:.2f} frames/s; kernel launches {main_launches}, Gauss-Newton steps {main_steps}")
    check(s1["frames"] == 120 and np.isfinite(ate1), "scale-1 run incomplete")
    check(main_launches == per_align * (s1["frames"] - 1), f"main path launched the kernel {main_launches} times")
    check(main_steps == ctx["steps_per_align"] * (s1["frames"] - 1),
          f"main path launched the step kernel {main_steps} times")
    ctx["tracker_s1"] = tracker

    # the same run with the tracker's stages eager
    pt.depth_to_cloud = lambda depth, proj, config=cv.ConverterConfig(), sensor_offset=None: cv._depth_to_cloud(
        depth, proj, config, sensor_offset)
    pt.align = lambda ref, cur, proj, guess=None, config=al.AlignerConfig(), priors=None: al._align(
        ref, cur, proj, guess, config, priors)
    try:
        e1, eager_tracker = scale1("_eager")
    finally:
        pt.depth_to_cloud, pt.align = cv.depth_to_cloud, al.align
    same = same_bits((tracker.trajectory_array(), eager_tracker.trajectory_array())) and all(
        m == n for m, n in zip(tracker.metrics, eager_tracker.metrics))
    say("graphs", f"scale 1 (640x480): trajectory and per-frame inliers, fractions, keyframes and chi2 bit-equal to "
        f"a run with the stages eager: {same}; {s1['frames_per_s']:.2f} frames/s by the graphs, "
        f"{e1['frames_per_s']:.2f} eager")
    check(same, "the scale-1 tracker's graphs differ from its eager stages")
    ctx["tracker_fps"] = dict(scale2=s2["frames_per_s"], scan=sc["frames_per_s"], scale1=s1["frames_per_s"],
                              scale1_eager=e1["frames_per_s"])
    ctx["captures"] = report_captures("graphs", ctx.get("captures", 0))
    return main_launches, main_steps


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
    """Phase 7: align_batch at K = 8 against K serial align calls on the
    plain Gauss-Newton tail, the one align_batch takes (T within 1e-4,
    inliers equal); the serial calls on the main path's step kernel
    against those on the plain tail (T within 1e-5 m and 1e-6 rad, inliers
    within 0.01%); align_batch's graph against its eager body (bit for
    bit, and timed in turns)."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn import aligner as al
    from g2o_frontend_tpu_torch.pwn.aligner import align, align_batch
    from tools.graph_probe import same_bits as same_tree
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

    def plain_step(cur_packed, ref_table, params, invT, projector, cfg, reorthonormalize):
        sums = fa.fused_system(cur_packed, ref_table, params, projector, cfg)
        return fa.step_reference(sums, invT, cfg.damping, reorthonormalize)

    fused_step, fa.fused_step = fa.fused_step, plain_step
    try:  # eager: the graph of align holds the step kernel
        plain = [al._align(ref, cur, proj, guesses[k], acfg, None) for k, ref in enumerate(ctx["ref_list"])]
    finally:
        fa.fused_step = fused_step
    dt_step = max(float(np.linalg.norm((s.T - p.T)[:3, 3].double().cpu().numpy())) for s, p in zip(serial, plain))
    dr_step = max(rot_err(s.T.cpu().numpy(), p.T.cpu().numpy()) for s, p in zip(serial, plain))
    di_step = max(abs(int(s.inliers) - int(p.inliers)) / int(p.inliers) for s, p in zip(serial, plain))
    say("align_batch", f"K={K_CANDIDATES} serial align, the step kernel against the plain tail: max translation "
        f"{dt_step:.3e} m, rotation {dr_step:.3e} rad, inliers {100 * di_step:.4f}% apart; inliers "
        f"{[int(s.inliers) for s in serial]} (plain tail {[int(p.inliers) for p in plain]})")
    check(dt_step < 1e-5 and dr_step < 1e-6 and di_step <= 1e-4,
          "serial align on the step kernel differs from the plain tail")
    serial = plain  # align_batch's tail
    dT = max(float((rb.T[k] - s.T).abs().max()) for k, s in enumerate(serial))
    t_err = max(float(np.linalg.norm((np.linalg.inv(ctx["T_true"][k]) @ rb.T[k].double().cpu().numpy())[:3, 3]))
                for k in range(K_CANDIDATES))
    inl_b = [int(x) for x in rb.inliers.cpu()]
    inl_s = [int(s.inliers) for s in serial]
    say("align_batch", f"K={K_CANDIDATES}: max |T - serial T| {dT:.2e} (serial on the plain tail); max t_err "
        f"{t_err:.3e} m; inliers {inl_b} (serial {inl_s}); kernel-2 launches +{grew2}, kernel-1 launches +{grew1}")
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
    say("timing", f"align_batch K={K_CANDIDATES} vs {K_CANDIDATES} serial align (each by its graph): CUDA events "
        f"median of 10 {ev_b:.3f} ms vs {ev_s:.3f} ms; device time (torch.profiler) {dev_b:.4f} ms vs {dev_s:.4f} ms")

    def eager():
        return al._align_batch(ctx["refs"], cur, proj, guesses, acfg)

    check(same_tree(rb, eager()), "align_batch's graph differs from its eager body")
    say("graphs", f"align_batch at K={K_CANDIDATES}: the graph's outputs bit-equal to its eager body's")
    graph_turns(ctx, f"align_batch K={K_CANDIDATES} {proj.rows}x{proj.cols}", batched, eager, 10)
    ctx["captures"] = report_captures("graphs", ctx.get("captures", 0))


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

    lin.launches, before1, steps = 0, fa.launches, fa.step_launches  # kernel 3's path: the z-buffer association
    res = al.align(ctx["ref"], ctx["cur"], proj, config=zcfg)
    torch.cuda.synchronize()
    launches = lin.launches
    check(fa.step_launches == steps, "align with the z-buffer association launched the step kernel")
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
    times the two designs in turns at every other K of the run. The
    closer's map is phase 5's scale-1 run; its align_batch calls replay
    graphs, so each call is recorded and run again on the eager body (bit
    for bit the graph's outputs), which records every kernel-2 launch's
    inputs. Keeps the largest batch's inputs in ctx["k_max"] for phase 10."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.apps import pwn_odometry, pwn_slam
    from g2o_frontend_tpu_torch.apps.profile_gather import bit_equal, system_bytes
    from g2o_frontend_tpu_torch.graph.reflector import MapReflector
    from g2o_frontend_tpu_torch.io import tum
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn import aligner as al
    from g2o_frontend_tpu_torch.slam import pwn_matcher
    from g2o_frontend_tpu_torch.slam.map_closer import CloserConfig, MapCloser
    from g2o_frontend_tpu_torch.slam.map_merger import MapMerger
    from g2o_frontend_tpu_torch.utils.profiling import bound, graph_ms, in_turns
    from tools.graph_probe import same_bits as same_tree

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
    # synthetic mode's 96x128 values to the image area. The map is phase
    # 5's scale-1 run (the tracker at new_frame_inliers_fraction 0.75).
    proj, ccfg, acfg = pwn_odometry.configs(1, "kinect")
    area = proj.rows * proj.cols / (96 * 128)
    cfg = CloserConfig(translational_distance=1.0, consensus_min_times_checked=1,
                       frame_min_nonzero_threshold=int(2000 * area), frame_max_outliers_threshold=int(6000 * area),
                       frame_min_inliers_threshold=int(2000 * area))
    timestamps = [ts for ts, _ in tum.read_depth_index(SEQ)]
    tracker = ctx["tracker_s1"]
    check(tracker.cfg.new_frame_inliers_fraction == 0.75 and (tracker.projector, tracker.ccfg, tracker.acfg)
          == (proj, ccfg, acfg) and tracker.frame_count == len(timestamps), "phase 5's tracker is not the map's run")
    mgr = tracker.manager
    nodes = list(mgr.nodes)
    ate_before = keyframe_ate(nodes, timestamps)
    closer = MapCloser(mgr, tracker.cache, proj, acfg, cfg)
    merger = MapMerger(mgr, list_size=5)
    reflector = MapReflector(mgr, device=device)
    # keep the inputs and outputs of every align_batch call of this run (its
    # graph replays kernel 2); the calls are run again below on the eager
    # body, which records the inputs of each kernel-2 launch
    batch_calls, graphed = [], pwn_matcher.align_batch

    def recording(references, current, projector, initial_guesses, config):
        out = graphed(references, current, projector, initial_guesses, config)
        batch_calls.append(((references, current, projector, initial_guesses, config), out))
        return out

    pwn_matcher.align_batch = recording
    fa.batch_launches, before1 = 0, fa.launches
    t0 = time.perf_counter()
    committed = 0
    try:
        for node in nodes[2:]:
            committed += len(closer.process_key_node(node))
            merger.process_key_node(node)
    finally:
        pwn_matcher.align_batch = graphed
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
    check(len(batch_calls) == len(batches), f"{len(batch_calls)} align_batch calls recorded for {len(batches)} batches")

    # every recorded call again on align_batch's eager body: its outputs
    # bit-equal to the graph's, and the inputs of each of its kernel-2
    # launches recorded (the graph launched the same kernels on the same
    # inputs, or the outputs would differ)
    calls, batch_kernel = [], fa.fused_system_batch

    def recording_kernel(cur_packed, ref_tables, params, projector, acfg_):
        calls.append((cur_packed, ref_tables, params, projector, acfg_))
        return batch_kernel(cur_packed, ref_tables, params, projector, acfg_)

    fa.fused_system_batch = recording_kernel
    try:
        for b, (args, out) in enumerate(batch_calls):
            check(same_tree(al._align_batch(*args), out),
                  f"closer batch {b}: align_batch's graph differs from its eager body")
    finally:
        fa.fused_system_batch = batch_kernel
    say("graphs", f"the closer's {len(batch_calls)} align_batch calls (K {batches}) again on the eager body: "
        f"every output bit-equal to the graph's; {len(calls)} kernel-2 launches recorded")
    check(len(calls) == launches, f"{len(calls)} kernel-2 calls recorded, {launches} launches counted")
    args = max(batch_calls, key=lambda c: c[0][0].p.shape[0])[0]
    graph_turns(ctx, f"align_batch K={args[0].p.shape[0]} {proj.rows}x{proj.cols} (the closer's largest batch)",
                lambda: al.align_batch(*args), lambda: al._align_batch(*args), 10)
    ctx["captures"] = report_captures("graphs", ctx.get("captures", 0))

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
    from g2o_frontend_tpu_torch.utils.profiling import graph_ms

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

    # the launch floor of rows 4-7: a one-element add_ timed as they are
    # (graph_ms, 50 and 12 calls a graph), before and after them
    one = torch.zeros(1, device=ctx["device"])
    floor = [graph_ms(lambda: one.add_(1), one, 50)]
    entries = []
    names = ("take_along_lanes_8x128", "take_along_lanes_8x1024", "take_along_sublanes_1024x128",
             "flat_gather_64x128")
    for name, g in zip(names, pg.tpu_probes(ctx["device"])):
        entries.append(entry(name, g, *counted(g), pg.measure(g, n=50)))
    floor.append(graph_ms(lambda: one.add_(1), one, 50))
    say("timing", f"launch floor of the probes: a one-element add_, device ms per call by CUDA graph replays at their "
        f"call counts, before and after them: {floor[0]:.6f}, {floor[1]:.6f}; the probes "
        + ", ".join(f"{e['name']} {e['ms']:.6f} ({e['ms'] / min(floor):.2f}x)" for e in entries))
    for e in entries:
        e["launch_floor_ms"] = min(floor)
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


def report_captures(phase, since):
    """One line for each key captured since the `since`-th (utils/graphs):
    its stage, tensor shapes, capture ms, the bytes it added to the shared
    pool and its static inputs. Returns the number of keys so far."""
    from g2o_frontend_tpu_torch.utils import graphs

    caps = graphs.captures()
    for c in caps[since:]:
        shapes = ", ".join("x".join(map(str, sh)) or "()" for sh in c.shapes[:3]) + (", ..." if len(c.shapes) > 3
                                                                                    else "")
        say(phase, f"captured {c.stage} ({len(c.shapes)} tensors: {shapes}) in {c.capture_ms:.1f} ms; pool "
            f"+{c.pool_bytes} B, static inputs {c.input_bytes} B; launches a replay {c.launches}")
    return len(caps)


def graph_turns(ctx, name, graphed, eager, n):
    """A stage's graph against its eager body in turns (tools/graph_probe.
    turns): one timing line, the row kept in ctx["stage_ms"]."""
    from tools.graph_probe import turns

    row = turns(name, graphed, eager, n)
    gdev = "not measured" if row["graph_device_ms"] is None else f"{row['graph_device_ms']:.4f} ms"
    say("timing", f"{name}, whole calls by CUDA events, median of {n}, in turns (eager, graph, graph, eager): graph "
        f"{row['graph_ms']:.4f} ms ({row['graph_runs_ms'][0]:.4f}, {row['graph_runs_ms'][1]:.4f}), eager "
        f"{row['eager_ms']:.4f} ms ({row['eager_runs_ms'][0]:.4f}, {row['eager_runs_ms'][1]:.4f}), "
        f"{row['speedup']:.2f}x; device time (torch.profiler) graph {gdev}, eager {row['eager_device_ms']:.4f} ms; "
        f"device idle {100 * row['graph_idle_share']:.1f}% of a replayed call, {100 * row['eager_idle_share']:.1f}% "
        f"of an eager one")
    ctx.setdefault("stage_ms", []).append(row)
    return row


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

    launches = ctx.setdefault("segment_sum_launches", {})
    map_merger.fuse_clouds = recording
    try:
        t0 = time.perf_counter()
        n_fused = counted(lambda: map_merger.MapMerger(mgr, cloud_cache=tracker.cache).collapse_redundant(*gates),
                          launches, "fusion")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        map_merger.fuse_clouds = fuse
    say("pwn", f"(b) MapMerger(cloud_cache=...).collapse_redundant over {len(ctx['slam']['nodes'])} keyframes, "
        f"gates {gates[0]:.6g} m / {gates[1]:.6g} rad ({'the JAX defaults' if widen == 1.0 else 'widened'}; "
        f"{sum(s <= 1 for s in scales)} of {len(scales)} accepted closures within the defaults): {n_fused} pairs "
        f"fused in {secs:.3f} s")
    check(n_fused >= 1 and len(calls) == n_fused, f"{n_fused} pairs fused, {len(calls)} fusions recorded")

    worst_share, fusion_ms, voxel_ms, voxel_launches = 0.0, [], {0.02: [], 0.1: []}, {}
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
        if i == 0:  # phase 14 (e) holds the segment sums of this fusion and its voxels
            recorded = ctx.setdefault("sums_recorded", [])
            recorded += [("fusion", "fusion", c) for c in record_sums(lambda: fuse(*args))]
            for res in voxel_ms:
                recorded += [(f"voxels at {res} m", "voxels", c) for c in
                             record_sums(lambda: voxelize(fused.points, fused.mask, res, 1 << 16))]
        # (c) voxel downsampling of the fused cloud
        for res in voxel_ms:
            c, n, occ = counted(lambda: voxelize(fused.points, fused.mask, res, 1 << 16), voxel_launches,
                               f"voxels {i} {res}")
            voxel_ms[res].append(median_ms(lambda: voxelize(fused.points, fused.mask, res, 1 << 16)))
            cc, nc, occ_c = voxelize(fused.points.cpu(), fused.mask.cpu(), res, 1 << 16)
            c_ok, c_err = close(c[occ], cc[occ_c])
            say("pwn", f"(c) fusion {i} at {res} m: {int(occ.sum())} voxels occupied of {1 << 16}, "
                f"{voxel_ms[res][-1]:.3f} ms; against the CPU: occupancy and counts "
                f"{'equal' if torch.equal(occ.cpu(), occ_c) and torch.equal(n.cpu(), nc) else 'DIFFER'}, centroids "
                f"within {c_err:.3e}")
            check(torch.equal(occ.cpu(), occ_c) and torch.equal(n.cpu(), nc) and c_ok,
                  f"voxels of fusion {i} at {res} m differ from the CPU")
    launches["voxels"] = sum(voxel_launches.values())
    say("pwn", f"(b), (c) segment-sum kernel launches: fusion {launches['fusion']}, voxels {launches['voxels']}")
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
    from g2o_frontend_tpu_torch.utils.evaluation import pose7_to_T

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
    T_gt = np.linalg.inv(pose7_to_T(gt[0])) @ pose7_to_T(gt[3])
    t_err = float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))
    say("pwn", f"(f) cloud_aligner on TUM frames 0 and 3 at 640x480: inliers {r['inliers']}, chi2 {r['chi2']:.6g}, "
        f"|t| {float(np.linalg.norm(T[:3, 3])):.4f} m, t_err against the ground truth {t_err:.3e} m, "
        f"valid {r['valid']}")
    check(np.isfinite(T).all() and r["valid"] and t_err < 0.01, f"cloud_aligner t_err {t_err} m")


# Phase 12's iteration caps: each gate is met inside them on the CPU at the
# same sizes (the Schur solve passes 1.01x the control at its 14th LM
# iteration, the dense one by its 3rd). The runs held against the CPU
# start at a larger lambda than the solvers' 1e-6: there the first steps
# are float32 solves of a nearly undamped system, and the trace moves with
# the summation order alone. Permuting the edges on the CPU moved the
# Schur trace by 0.78% from 1e-6, by up to 6.2e-4 from 1e-4 and by up to
# 5.2e-5 from 1e-3 (four orders); the 1,000-pose dense one by 1.7% from
# 1e-6 and by up to 2.1e-4 from 1e-4 (six orders).
SCHUR_CAPS = dict(iters=16, cg_iters=200, lm_lambda0=1e-3)
DIRECT_ITERS = 30
DIRECT_VS_CPU = dict(iters=30, lm_lambda0=1e-4)
PCG_CAPS = dict(iters=10, cg_iters=60)  # the pose-only world, both preconditioners (not gated)
SE3_300_CAPS = dict(iters=10, cg_iters=100, precond="chain")
SE3_2000_CAPS = dict(iters=10, cg_iters=100, precond="chain")  # not gated
VICTORIA = dict(n_poses=7120, n_landmarks=151, world_size=60.0, seed=0)  # victoriaPark's counts (bench.py:396)
BENCH_SE3 = dict(n_poses=300, seed=0, world_size=20.0, closure_min_gap=50, closure_radius=3.5, closure_prob=0.9)


def profiled(fn):
    """(fn(), wall ms by CUDA events, device ms and device operations that
    torch.profiler's CUDA activity records) of one call. Only the CUDA
    activity is traced, so that host dispatch runs at its own speed.
    Turning a trace into its events costs ~0.25 ms of host time for each
    one, so phase 12 traces one LM iteration of a solve, not all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall = timed(fn)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    device = sum(e.device_time_total for e in kernels) / 1000.0
    check(device > 0, "torch.profiler recorded no device time")
    return out, wall, device, sum(e.count for e in kernels)


def host_s(fn):
    """(fn(), its seconds by the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


CPU_WORKER_THREADS = 2  # the worker's torch threads; the main process keeps the card fed


def _cpu_worker_init():
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)


def cpu_worker(ctx):
    """The process (spawned on first use, one for the run) that repeats the
    long CPU runs of phases 12 and 14 while the card works on: the same
    functions on the same inputs, at full depth, off the critical path."""
    if "cpu_pool" not in ctx:
        import multiprocessing

        ctx["cpu_pool"] = multiprocessing.get_context("spawn").Pool(1, initializer=_cpu_worker_init)
    return ctx["cpu_pool"]


def cpu_schur(path):
    """Phase 12 (b)'s Schur solve on the CPU (in the worker), on the graph
    of the file phase 12 (a) wrote: (chi2 trace, LM iterations, CG
    iterations, seconds)."""
    import numpy as np

    from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
    from g2o_frontend_tpu_torch.io import g2o
    from g2o_frontend_tpu_torch.solvers import schur_pcg as sp

    gc, _ = graph2d_from_log(g2o._read_g2o_native(path), device="cpu")
    (_, st), seconds = host_s(lambda: sp.optimize_se2_schur(gc, **SCHUR_CAPS))
    return np.asarray(st.chi2), int(st.lm_iters), int(st.cg_iters), seconds


def solve_line(name, solve, one_iteration, lm_of, cg_of=None):
    """Run `solve` once timed by CUDA events, and `one_iteration` (the same
    solve capped at one LM iteration) once under torch.profiler; one line
    with the wall ms, LM and CG iterations and LM iterations/s of the
    first, and the device ms, device operations and busy share of the
    second. Returns (the solve's result, the line)."""
    out, wall = timed(solve)
    _, wall1, dev1, ops1 = profiled(one_iteration)
    lm = lm_of(out[1])
    cg = f", CG iterations {cg_of(out[1])}" if cg_of else ""
    return out, (f"{name}: wall {wall:.3f} ms (CUDA events), LM iterations {lm}{cg}, {1000.0 * lm / wall:.2f} LM "
                 f"iterations/s; one LM iteration under torch.profiler: wall {wall1:.3f} ms, device {dev1:.3f} ms "
                 f"({100.0 * dev1 / wall1:.1f}% busy), {ops1} device operations")


def trace_close(a, b, rtol):
    """Two chi2 traces within `rtol` elementwise; their largest relative
    difference. Prints both where they are not."""
    a, b = a.cpu().double(), b.cpu().double()
    rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    if rel > rtol:
        say("backend", f"traces: card {a.tolist()}, CPU {b.tolist()}")
    return rel <= rtol, rel


def same_bits(*pairs):
    """Every (a, b) pair of tensors or numpy arrays equal bit for bit (the
    same shape, dtype and bytes)."""
    import numpy as np
    import torch

    for a, b in pairs:
        a, b = (x.detach().cpu().contiguous().numpy() if torch.is_tensor(x) else np.ascontiguousarray(x)
                for x in (a, b))
        if a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            return False
    return True


def graphed_solve(label, fn, one_iteration, lm_of, cg_of=None, launches=None, key=None, eager_turns=2):
    """Phases 12 and 14's runs of one solver (utils/graphs.solve_loop):
    graphed twice (the key's first call, its CG blocks graphed; its second,
    the chain captured and replayed) and eager once ("eager" mode: the
    eager port, a host read a CG iteration), all bit-equal (trace, poses,
    landmarks, lambda, LM and CG counts); the whole solve graph against
    eager in turns (eager, graph, graph, eager; with `eager_turns` 1 the
    last eager run is left out) by CUDA events; host reads a solve; one LM
    iteration, graphed, under torch.profiler; the captures. Returns (the
    first result, its lines); with `launches`, the first call's segment-sum
    launches go to launches[key]."""
    from g2o_frontend_tpu_torch.utils import graphs
    from tools.graph_probe import solver_leaves

    def eager():
        with graphs.mode("eager"):
            return fn()

    since = len(graphs.captures())
    runs, reads = [], []
    for f in ((lambda: counted(fn, launches, key)) if launches is not None else fn, fn, eager, fn, fn,
              eager)[: 4 + eager_turns]:
        graphs.host_reads = 0
        runs.append(timed(f))
        reads.append(graphs.host_reads)
    (out, first_ms), (out2, capture_ms), (out_e, e1), (_, g1), (_, g2) = runs[:5]
    e2 = runs[5][1] if eager_turns > 1 else e1
    same = same_bits(*zip(solver_leaves(out), solver_leaves(out2))) and same_bits(
        *zip(solver_leaves(out), solver_leaves(out_e)))
    check(same, f"{label}: a graphed solve differs from its eager mode")
    one_iteration()
    one_iteration()  # its key captured
    _, wall1, dev1, ops1 = profiled(one_iteration)
    caps = graphs.captures()[since:]
    kept = [c for c in caps if c.kept]
    cg = f", CG iterations {cg_of(out[1])}" if cg_of else ""
    lines = [f"{label}: LM iterations {lm_of(out[1])}{cg}; graphed, eager bit-equal {same} (two graphed, one "
             f"eager); whole solve by CUDA events in turns (eager, graph, graph, eager): graph {min(g1, g2):.3f} ms "
             f"({g1:.3f}, {g2:.3f}), eager {min(e1, e2):.3f} ms ({e1:.3f}, {e2:.3f}), {min(e1, e2) / min(g1, g2):.2f}x; "
             f"the key's first call {first_ms:.3f} ms, its second (the chain's capture) {capture_ms:.3f} ms; host "
             f"reads a solve: graphed {reads[3]}, eager {reads[2]}; one LM iteration graphed under torch.profiler: "
             f"wall {wall1:.3f} ms, device {dev1:.3f} ms ({100.0 * dev1 / wall1:.1f}% busy), {ops1} device "
             "operations",
             f"{label}: captures {len(kept)} kept ("
             + ", ".join(f"{c.stage.split(': ')[-1]} {c.capture_ms:.1f} ms, pool +{c.pool_bytes} B" for c in kept)
             + f"), {len(caps) - len(kept)} CG-block graphs dropped at their solve's end ("
             f"{sum(c.capture_ms for c in caps if not c.kept):.1f} ms)"]
    return out, lines, dict(graph_ms=min(g1, g2), eager_ms=min(e1, e2), reads_graph=reads[3], reads_eager=reads[2],
                            capture_ms=capture_ms, pool_bytes=sum(c.pool_bytes for c in kept))


class SolverCalls:
    """Within the block, every call of the public solvers that the callers
    of phases 9, 13, 14 and 16 reach (`optimize_se2`, `optimize_se3`,
    `optimize_se2_schur`, `landmark_covariance_se2`) on the card timed
    graphed (the host clock between synchronisations), its arguments and
    result kept.
    `report` reruns the calls in "eager" mode, in order, until `budget_s` of
    eager time: each bit-equal to its graphed result, the two times
    compared, and prints them with the captures made in the block."""

    def __init__(self, phase, budget_s=10.0):
        self.phase, self.budget_s, self.calls = phase, budget_s, []

    def __enter__(self):
        from g2o_frontend_tpu_torch.graph import reflector
        from g2o_frontend_tpu_torch.slam import grid_slam
        from g2o_frontend_tpu_torch.solvers import pose_graph as pg
        from g2o_frontend_tpu_torch.solvers import schur_pcg as sp
        from g2o_frontend_tpu_torch.utils import graphs

        self.since = len(graphs.captures())
        self.saved = []
        wrapped = {}
        for mod, name in ((pg, "optimize_se2"), (pg, "optimize_se3"), (sp, "optimize_se2_schur"),
                          (sp, "landmark_covariance_se2"), (grid_slam, "optimize_se2"), (reflector, "optimize_se3")):
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            if fn not in wrapped:
                wrapped[fn] = self._wrap(name, fn)
            setattr(mod, name, wrapped[fn])
        return self

    def _wrap(self, name, fn):
        import torch

        def call(*args, **kwargs):
            if args[0].poses.device.type != "cuda":  # a CPU run beside the card's
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append((name, fn, args, kwargs, out, time.perf_counter() - t0))
            return out

        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def report(self):
        import torch

        from g2o_frontend_tpu_torch.utils import graphs
        from tools.graph_probe import solver_leaves

        graphed = eager = 0.0
        rerun, same = 0, True
        for name, fn, args, kwargs, out, seconds in self.calls:
            if eager >= self.budget_s:
                break
            with graphs.mode("eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out_e = fn(*args, **kwargs)
                torch.cuda.synchronize()
            eager += time.perf_counter() - t0
            graphed += seconds
            rerun += 1
            same = same and same_bits(*zip(solver_leaves(out), solver_leaves(out_e)))
        caps = graphs.captures()[self.since:]
        chains = [c for c in caps if c.kept and ": " in c.stage]  # a solve's head, block and tail
        by = {}
        for name, *_ in self.calls:
            by[name] = by.get(name, 0) + 1
        total = sum(c[-1] for c in self.calls)
        ratio = f"{eager / graphed:.2f}x" if graphed else "no call"
        say(self.phase, f"solver calls {len(self.calls)} {json.dumps(by)}, graphed {1000 * total:.1f} ms in all; the "
            f"first {rerun} rerun in eager mode: graphed {1000 * graphed:.1f} ms, eager {1000 * eager:.1f} ms "
            f"(eager / graphed {ratio}), bit-equal {same}; captures: {len(chains)} solve graphs kept "
            f"({sum(c.capture_ms for c in chains):.1f} ms, pool +{sum(c.pool_bytes for c in chains)} B), "
            f"{len([c for c in caps if not c.kept])} CG-block graphs dropped at their solve's end "
            f"({sum(c.capture_ms for c in caps if not c.kept):.1f} ms), "
            f"{len([c for c in caps if c.stage.startswith('landmark')])} covariance stages")
        check(same, f"phase {self.phase}: a caller's graphed solve differs from its eager mode")
        return dict(calls=len(self.calls), rerun=rerun, graphed_ms=1000 * graphed, eager_ms=1000 * eager)


def counted(fn, into, key):
    """fn() with `ops.segment_sum`'s launch count set to 0 just before and
    read just after, into `into[key]`."""
    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    ss.launches = 0
    out = fn()
    into[key] = ss.launches
    return out


def logs_equal(a, b):
    """Field-by-field equality of two G2OLogs."""
    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) and not (x.shape == y.shape and np.array_equal(x, y)):
            return f.name
    return None


def write_noassoc_g2o(path, world):
    """A simulated world as a *noassoc* log (the reference's
    ``world-2000-noassoc`` format): VERTEX_SE2 at the odometry-integrated
    poses, each followed by its observations as DATA_FEATURE_POINTXY rows
    without landmark ids, then the EDGE_SE2 odometry."""
    import numpy as np

    poses = world.noisy_init()
    by_pose = {}
    for (p, _l, z, w) in world.observations:
        by_pose.setdefault(p, []).append((z, w))
    lines = []
    for i, pose in enumerate(poses):
        x, y, th = (float(v) for v in pose)
        lines.append(f"VERTEX_SE2 {i} {x!r} {y!r} {th!r}")
        for z, w in by_pose.get(i, ()):
            lines.append(f"DATA_FEATURE_POINTXY 0 2 {float(z[0])!r} {float(z[1])!r} {float(w[0, 0])!r} "
                         f"{float(w[0, 1])!r} {float(w[1, 1])!r}")
    for (i, j, z, w) in world.odom_edges:
        info = " ".join(repr(float(w[a, b])) for a in range(3) for b in range(a, 3))
        lines.append(f"EDGE_SE2 {i} {j} {float(z[0])!r} {float(z[1])!r} {float(z[2])!r} {info}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return np.asarray(poses)


def phase_backend(ctx, out_dir):
    """Phase 12: slice 3, the 2D pose-graph backend at victoriaPark's size
    (7,120 poses, 151 landmarks, 21,662 DOF) on a simulated world. (a) The
    world through write_g2o and back through the native and the Python
    parsers; (b) optimize_se2_schur and optimize_se2_direct against the
    float64 control, Schur again on the CPU (in the worker, read at the end
    of the phase), the dense solve on a 1,000-pose
    world on both; (c) the pose-only world through optimize_se2 (jacobi,
    chain) on both; (d) landmark_covariance_se2 on both, graph_optimizer on
    the written file; (e) optimize_se3 (chain) on bench.py's 300-pose world
    and on the default 2,000-pose world against the control, and
    graph_optimizer on an SE3 file."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch import native
    from g2o_frontend_tpu_torch.apps import graph_optimizer
    from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
    from g2o_frontend_tpu_torch.io import g2o
    from g2o_frontend_tpu_torch.slam.simulator import Simulator3DConfig, SimulatorConfig, simulate, simulate_se3
    from g2o_frontend_tpu_torch.solvers import pose_graph as pg
    from g2o_frontend_tpu_torch.solvers import schur_pcg as sp
    from g2o_frontend_tpu_torch.solvers.control import control_optimize_se2, control_optimize_se3
    from g2o_frontend_tpu_torch.utils import graphs

    device, t12 = ctx["device"], time.perf_counter()

    # (a) the world, its file and the two parsers
    lib, build_s = host_s(native.build)
    world = simulate(SimulatorConfig(**VICTORIA))
    path = os.path.join(out_dir, "victoria_sim.g2o")
    g2o.write_g2o(path, world.to_g2o_log())
    fast, native_s = host_s(lambda: g2o._read_g2o_native(path))
    slow, python_s = host_s(lambda: g2o.read_g2o(path, native=False))
    check(fast is not None, "the native parser returned nothing")
    differ = logs_equal(fast, slow)
    check(differ is None, f"native and Python parses differ in {differ}")
    n_dof = 3 * len(fast.se2_ids) + 2 * len(fast.xy_ids)
    say("backend", f"(a) native parser {os.path.relpath(lib, REPO)} (built in {build_s:.2f} s); world: "
        f"{len(fast.se2_ids)} poses, {len(world.odom_edges)} odometry and {len(world.closure_edges)} closure edges, "
        f"{len(fast.xy_ids)} landmarks, {len(world.observations)} landmark observations, {n_dof} DOF; file "
        f"{os.path.getsize(path)} B; parse ms native {1000 * native_s:.1f}, Python {1000 * python_s:.1f}; equal")
    check(n_dof == 21662, f"{n_dof} DOF, not 21,662")
    schur_cpu = cpu_worker(ctx).apply_async(cpu_schur, (path,))  # read at the end of the phase
    ctx["slice5_cpu"] = cpu_worker(ctx).apply_async(cpu_slice5)  # for phase 14

    # (b) Schur and dense solves against the float64 control
    g, _ = graph2d_from_log(fast, device=device)
    gc, _ = graph2d_from_log(fast, device="cpu")
    ctl, ctl_s = host_s(lambda: control_optimize_se2(gc))
    ctx["victoria"] = dict(path=path, g=g, gc=gc, ctl=ctl)  # for phase 15
    say("backend", f"(b) control_optimize_se2 (float64, host): chi2 {ctl['chi2']:.6f} in {ctl['iters']} LM "
        f"iterations, {ctl_s:.2f} s")
    woodbury = 2 * g.landmarks.shape[0] <= sp.WOODBURY_MAX_DIM
    launches = ctx.setdefault("segment_sum_launches", {})
    (gs, ss), lines, times = graphed_solve(f"(b) optimize_se2_schur {SCHUR_CAPS}, Woodbury {woodbury}",
                                           lambda: sp.optimize_se2_schur(g, **SCHUR_CAPS),
                                           lambda: sp.optimize_se2_schur(g, **{**SCHUR_CAPS, "iters": 1}),
                                           lambda st: st.lm_iters, lambda st: st.cg_iters, launches, "schur",
                                           eager_turns=1)  # one eager Schur solve (~17-19 s) holds its time
    ctx.setdefault("solve_ms", {})["schur"] = times
    ratio = float(ss.chi2[-1]) / ctl["chi2"]
    for line in lines:
        say("backend", line)
    say("backend", f"(b) optimize_se2_schur: chi2 {float(ss.chi2[-1]):.6f}, {ratio:.6f}x the control; segment-sum "
        f"kernel launches {launches['schur']} ({launches['schur'] / max(ss.cg_iters, 1):.1f} a CG iteration)")
    check(ratio <= 1.01, f"optimize_se2_schur reached {ratio:.6f}x the control")
    torch.cuda.reset_peak_memory_stats()
    (gd, sd), lines, times = graphed_solve(
        f"(b) optimize_se2_direct (iters={DIRECT_ITERS}, dense {n_dof}^2 float32 Cholesky)",
        lambda: pg.optimize_se2_direct(g, iters=DIRECT_ITERS), lambda: pg.optimize_se2_direct(g, iters=1),
        lambda st: st.cg_iters)
    ctx["solve_ms"]["direct"] = times
    ratio = float(sd.chi2[-1]) / ctl["chi2"]
    for line in lines:
        say("backend", line)
    say("backend", f"(b) optimize_se2_direct: chi2 {float(sd.chi2[-1]):.6f}, {ratio:.6f}x the control; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the graphs' pool included)")
    check(ratio <= 1.01, f"optimize_se2_direct reached {ratio:.6f}x the control")
    small = simulate(SimulatorConfig(**{**VICTORIA, "n_poses": 1000})).to_g2o_log()
    g1, _ = graph2d_from_log(small, device=device)
    g1c, _ = graph2d_from_log(small, device="cpu")
    (_, s1), line = solve_line(f"(b) optimize_se2_direct {DIRECT_VS_CPU}, 1,000-pose world "
                               f"({3 * 1000 + 2 * len(small.xy_ids)} DOF)",
                               lambda: pg.optimize_se2_direct(g1, **DIRECT_VS_CPU),
                               lambda: pg.optimize_se2_direct(g1, **{**DIRECT_VS_CPU, "iters": 1}),
                               lambda st: st.cg_iters)
    (_, s1c), cpu_s = host_s(lambda: pg.optimize_se2_direct(g1c, **DIRECT_VS_CPU))
    ok, rel = trace_close(s1.chi2, s1c.chi2, 1e-3)
    say("backend", line + f"; CPU {cpu_s:.2f} s, {s1c.cg_iters} LM iterations; traces within rtol {rel:.2e} "
        "(limit 1e-3)")
    check(ok, f"dense traces of the card and the CPU differ by {rel:.2e}")

    # (c) the pose-only world through PCG, both preconditioners
    pose_only = world.to_g2o_log(with_landmarks=False)
    g0, _ = graph2d_from_log(pose_only, device=device)
    g0c, _ = graph2d_from_log(pose_only, device="cpu")
    ctl0 = control_optimize_se2(g0c)
    for precond in ("jacobi", "chain"):
        (_, s0), lines, times = graphed_solve(
            f"(c) optimize_se2 pose-only ({len(pose_only.edge_se2_ij)} edges), {precond} {PCG_CAPS}",
            lambda: pg.optimize_se2(g0, precond=precond, **PCG_CAPS),
            lambda: pg.optimize_se2(g0, precond=precond, **{**PCG_CAPS, "iters": 1}), lambda st: PCG_CAPS["iters"],
            lambda st: st.cg_iters)
        ctx["solve_ms"][f"se2 {precond}"] = times
        (_, s0c), cpu_s = host_s(lambda: pg.optimize_se2(g0c, precond=precond, **PCG_CAPS))
        ok, rel = trace_close(s0.chi2, s0c.chi2, 1e-3)
        for line in lines:
            say("backend", line)
        say("backend", f"(c) {precond}: chi2 {float(s0.chi2[-1]):.4f}, {float(s0.chi2[-1]) / ctl0['chi2']:.4f}x the "
            f"control ({ctl0['chi2']:.4f}; not gated); CPU {cpu_s:.2f} s, traces within rtol {rel:.2e} (limit 1e-3)")
        check(ok, f"{precond} traces of the card and the CPU differ by {rel:.2e}")

    # (d) the landmark covariance and the command line
    cov_first = sp.landmark_covariance_se2(g)  # a key seen once: eager
    sp.landmark_covariance_se2(g)  # captured
    cov, wall, dev, ops = profiled(lambda: sp.landmark_covariance_se2(g))
    with graphs.mode("eager"):
        cov_e = sp.landmark_covariance_se2(g)
    same = same_bits((cov, cov_first), (cov, cov_e))
    say("backend", f"(d) landmark_covariance_se2: the replayed stage, its first (eager) call and its eager mode "
        f"bit-equal {same}")
    check(same, "the covariance stage differs from its eager body")
    cov_c = sp.landmark_covariance_se2(gc)
    # the landmarks that some pose observes (an unobserved one keeps its
    # damping's 1e10 variance in both packages)
    seen = torch.unique(gc.pl_ij[:, 1])
    cov, cov_c = cov.cpu()[seen][:, :, seen], cov_c[seen][:, :, seen]
    blocks = cov.double()[torch.arange(len(seen)), :, torch.arange(len(seen)), :]
    sym = float((blocks - blocks.transpose(1, 2)).abs().max() / blocks.abs().max())
    pd = bool((torch.linalg.eigvalsh(0.5 * (blocks + blocks.transpose(1, 2))) > 0).all())
    err, top = float((cov - cov_c).abs().max()), float(cov_c.abs().max())
    say("backend", f"(d) landmark_covariance_se2 ({g.landmarks.shape[0]} landmarks, {len(seen)} observed): wall "
        f"{wall:.3f} ms, device {dev:.3f} ms, device operations {ops} (torch.profiler); finite "
        f"{bool(torch.isfinite(cov).all())}, diagonal blocks asymmetric by {sym:.2e} of the largest entry, PD {pd}; "
        f"against the CPU max abs diff {err:.3e}, {err / top:.2e} of the largest entry {top:.3e} (limit 1e-3)")
    check(bool(torch.isfinite(cov).all()) and sym <= 1e-4 and pd, "landmark covariance not finite, symmetric and PD")
    check(err <= 1e-3 * top, f"landmark covariance differs from the CPU by {err / top:.2e} of its largest entry")
    out, app_s = host_s(lambda: graph_optimizer.run([path, "-o", os.path.join(out_dir, "victoria_opt.g2o"),
                                                      "--device", "cuda"]))
    direct = float(pg.optimize_se2(g, iters=15, cg_iters=100)[1].chi2[-1])
    say("backend", f"(d) graph_optimizer --device cuda on the file: {app_s:.2f} s, chi2 {out['chi2_initial']:.6g} -> "
        f"{out['chi2_final']:.6f}; a direct optimize_se2 call (the app's 15 / 100 iterations) {direct:.6f} "
        "(limit: equal, the same code on the same card)")
    check(out["chi2_final"] == direct and out["chi2_final"] < out["chi2_initial"],
          "graph_optimizer disagrees with optimize_se2")

    # (e) SE3
    for label, cfg, caps in (("bench.py's 300-pose world", Simulator3DConfig(**BENCH_SE3), SE3_300_CAPS),
                             ("the default 2,000-pose world", Simulator3DConfig(), SE3_2000_CAPS)):
        g3, info = simulate_se3(cfg, device=device)
        ctl3 = control_optimize_se3(g3.to("cpu"), max_iters=60)
        (_, s3), lines, times = graphed_solve(
            f"(e) optimize_se3 on {label} ({info['n_edges']} edges, {info['n_closures']} closures) {caps}",
            lambda: pg.optimize_se3(g3, **caps), lambda: pg.optimize_se3(g3, **{**caps, "iters": 1}),
            lambda st: caps["iters"], lambda st: st.cg_iters)
        ctx["solve_ms"][f"se3 {cfg.n_poses}"] = times
        ratio = float(s3.chi2[-1]) / ctl3["chi2"]
        ctx.setdefault("se3", {})[cfg.n_poses] = (g3, ctl3)  # for phase 15
        for line in lines:
            say("backend", line)
        say("backend", f"(e) {cfg.n_poses} poses: chi2 {float(s3.chi2[-1]):.4f}, control {ctl3['chi2']:.4f}, "
            f"{ratio:.6f}x")
        check(np.isfinite(ratio), "non-finite SE3 chi2")
        if cfg.n_poses == 300:  # the gate of bench.py's SE3 world (the 2,000-pose one is only reported)
            check(ratio <= 1.01, f"optimize_se3 on the 300-pose world reached {ratio:.6f}x the control")
            poses, e = g3.poses.cpu().double().numpy(), g3.pp_ij.shape[0]
            log3 = g2o.G2OLog(se3_ids=np.arange(len(poses)), se3_poses=poses, edge_se3_ij=g3.pp_ij.cpu().numpy(),
                              edge_se3_meas=g3.pp_meas.cpu().double().numpy(),
                              edge_se3_info=g3.pp_info.cpu().double().numpy().reshape(e, 6, 6),
                              fixed_ids=np.array([0]))
            path3 = os.path.join(out_dir, "se3_300.g2o")
            g2o.write_g2o(path3, log3)
            out3, app_s = host_s(lambda: graph_optimizer.run([path3, "-o", os.path.join(out_dir, "se3_opt.g2o"),
                                                               "--device", "cuda"]))
            say("backend", f"(e) graph_optimizer --device cuda on the SE3 file: {app_s:.2f} s, chi2 "
                f"{out3['chi2_initial']:.4f} -> {out3['chi2_final']:.4f} ({out3['chi2_final'] / ctl3['chi2']:.6f}x "
                "the control)")
            check(out3["dim"] == 3 and out3["chi2_final"] < out3["chi2_initial"], "graph_optimizer on SE3 failed")

    # (b)'s Schur solve repeated on the CPU, in the worker since (a)
    trace_cpu, lm_cpu, cg_cpu, cpu_s = schur_cpu.get()
    ok, rel = trace_close(ss.chi2, torch.from_numpy(trace_cpu), 1e-3)
    say("backend", f"(b) optimize_se2_schur on the CPU (the worker process, alongside (b)-(e)): {cpu_s:.2f} s, "
        f"{lm_cpu} LM / {cg_cpu} CG iterations; traces within rtol {rel:.2e} (limit 1e-3)")
    check(ok, f"Schur traces of the card and the CPU differ by {rel:.2e}")
    say("backend", f"phase 12 took {time.perf_counter() - t12:.1f} s")


# Phase 13: slice 4 at world-2000's counts (EVAL.md section 2: 2,001 poses,
# 70 landmarks); the world is the port's simulator with the rest at its
# defaults, its landmark ids stripped. The lockstep run holds the card to
# the CPU over the first 300 frames.
WORLD2000 = dict(n_poses=2001, n_landmarks=70, seed=0)
LOCKSTEP_FRAMES = 300
PROFILED_FRAMES = range(300, 319)  # after the lockstep run; frame 319 ends with a window solve (optimizeEachN 20)
TRACKER2D_FLAGS = ["-minLandmarkCreationFrames", "1", "-incrementalRansacInlierThreshold", "0.5",
                   "-loopRansacInlierThreshold", "0.2", "-loopLandmarkMergeDistance", "0.5", "-localMapSize", "10",
                   "-optimizeEachN", "20"]  # the world2000 recipe as the app's flags


def eval_schedule(tr):
    """EVAL section 2's closing schedule (scripts/evaluate.py:207-229) after
    the tracking loop: the 0.5/1.0/1.5 m merges, each with a global solve;
    three whole-trajectory sweeps with re-association; two Mahalanobis
    merge rounds. Returns the last chi2."""
    for d in (0.5, 1.0, 1.5):
        tr.merge_nearby_landmarks(d)
        tr.optimize(local=False)
    for _ in range(3):
        tr.close_loops_global(segment=200, gate=4.0)
        tr.merge_nearby_landmarks(0.75)
        tr.reassociate(gate=1.0)
        chi2 = tr.optimize(local=False)
    for gate in (9.21, 16.0):
        tr.merge_landmarks_mahalanobis(chi2_gate=gate, prefilter_distance=6.0)
        tr.reassociate(gate=1.0)
        chi2 = tr.optimize(local=False)
    return chi2


def profile_frames(fn):
    """(fn(), wall ms, device ms, device operations, host syncs) of one call
    under torch.profiler (CPU and CUDA activity): the syncs are the CUDA
    runtime's synchronize calls, one in each read of a device value."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1000.0 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    device = sum(e.device_time_total for e in kernels) / 1000.0
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    check(device > 0, "torch.profiler recorded no device time")
    return out, wall, device, sum(e.count for e in kernels), syncs


def figure_world(seed, n_lms=14):
    """tests/test_validated_slam.py's sparse world and 40-pose circle."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lms = rng.uniform(-9, 9, (n_lms, 2))
    path = [np.array([np.cos(t) * 5, np.sin(t) * 5, t + np.pi / 2]) for t in np.linspace(0, 2 * np.pi, 40,
                                                                                             endpoint=False)]
    return lms, path


def drifted_frames(lms, path, loops=2, drift=(8.0, 5.0, 0.0), drift_from=40, ramp=25, blind_ramp=True,
                   sense=6.0):
    """(odometry delta, observations) along `path` with a drift that ramps in
    over `ramp` frames from `drift_from` (tests/test_validated_slam.py's
    `_frames`; with `ramp` 0 it jumps, as tests/test_constellation.py:100),
    no observations while it ramps when `blind_ramp`."""
    import numpy as np

    prev = None
    for k, p in enumerate(path * loops):
        scale = np.clip((k - drift_from) / ramp, 0.0, 1.0) if ramp else float(k >= drift_from)
        est = p + np.asarray(drift) * scale
        rel = lms - p[:2]
        c, s = np.cos(p[2]), np.sin(p[2])
        local = rel @ np.array([[c, s], [-s, c]]).T
        vis = np.linalg.norm(rel, axis=1) < sense
        if blind_ramp and 0.0 < scale < 1.0:
            vis[:] = False
        if prev is None:
            delta = np.zeros(3)
        else:
            c2, s2 = np.cos(prev[2]), np.sin(prev[2])
            dd = est[:2] - prev[:2]
            delta = np.array([c2 * dd[0] + s2 * dd[1], -s2 * dd[0] + c2 * dd[1], est[2] - prev[2]])
        prev = est
        yield delta, local[vis]


def phase_slam2d(ctx, out_dir):
    """Phase 13: slice 4, 2D SLAM with unknown data association. (a) A world
    at world-2000's counts as a noassoc log through `tracker2d --device
    cuda` (the world2000 recipe's flags), then the same log through a
    `models.build("tracker2d", recipe="world2000")` tracker and EVAL
    section 2's schedule, ATE against the ground truth, the odometry and
    the float64 optimum of the known-association graph; the chains and
    stage keys captured; the same run in eager mode, bit-equal; (b) its first 300
    frames on the card and on the CPU in lockstep, the same draws; (c) the
    validated tracking loop, the constellation closure, graph merge and the model
    families at test size."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.apps import tracker2d
    from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
    from g2o_frontend_tpu_torch.io.g2o import G2OLog, read_g2o
    from g2o_frontend_tpu_torch.slam import graph_merge
    from g2o_frontend_tpu_torch.slam.feature_tracker import FeatureTracker2D, Tracker2DConfig, _se2_rel_np
    from g2o_frontend_tpu_torch.slam.simulator import SimulatorConfig, simulate
    from g2o_frontend_tpu_torch.slam.validated_slam import (ValidatedSlamConfig, finish_window_closures,
                                                            run_validated_tracking)
    from g2o_frontend_tpu_torch.solvers import pose_graph as pg
    from g2o_frontend_tpu_torch.solvers.control import control_optimize_se2
    from g2o_frontend_tpu_torch.utils.evaluation import ate_xy

    from g2o_frontend_tpu_torch.utils import graphs

    device, t13 = ctx["device"], time.perf_counter()
    chains0, caps0 = len(graphs._CHAINS), len(graphs.captures())

    # (a) the world-2000-size run
    world = simulate(SimulatorConfig(**WORLD2000))
    path = os.path.join(out_dir, "world2000_noassoc.g2o")
    odo = write_noassoc_g2o(path, world)
    log = read_g2o(path)
    frames = list(tracker2d.frames_of(log))
    seen = len({l for (_, l, _, _) in world.observations})
    say("slam2d", f"(a) world: {len(frames)} poses, {len(log.features)} observations without ids of {seen} landmarks "
        f"seen (of {len(world.landmarks)}), file {os.path.getsize(path)} B")
    out, app_s = host_s(lambda: tracker2d.run([path, "-o", os.path.join(out_dir, "world2000_opt.g2o"),
                                               *TRACKER2D_FLAGS, "--device", "cuda"]))
    say("slam2d", f"(a) tracker2d --device cuda, world2000 flags: {app_s:.2f} s, {len(frames) / app_s:.2f} frames/s "
        f"with the app's closing and final solve; {json.dumps(out)}")
    check(np.isfinite(out["chi2"]) and out["n_poses"] == len(frames), "tracker2d failed")

    tr = models.build("tracker2d", recipe="world2000", device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, (delta, obs, info) in enumerate(frames):
        tr.process_frame(delta, obs, info)
        if (k + 1) % 100 == 0:
            tr.close_loops()
    track_s = time.perf_counter() - t0
    n_tracked = int(tr.lm_alive.sum())
    chi2, sched_s = host_s(lambda: eval_schedule(tr))
    est = tr.trajectory()
    gt = world.gt_poses
    g_known, _ = graph2d_from_log(world.to_g2o_log(), device="cpu")
    ctl, ctl_s = host_s(lambda: control_optimize_se2(g_known, max_iters=40))
    ref = np.asarray(ctl["poses"])[: len(gt)]
    ate_gt, ate_odo = ate_xy(est[:, :2], gt[:, :2]), ate_xy(odo[:, :2], gt[:, :2])
    ate_ref, odo_ref = ate_xy(est[:, :2], ref[:, :2]), ate_xy(odo[:, :2], ref[:, :2])
    n_lm = int(tr.lm_alive.sum())
    say("slam2d", f"(a) tracking loop ({len(frames)} frames, close_loops every 100): {track_s:.2f} s, "
        f"{len(frames) / track_s:.2f} frames/s, {n_tracked} landmarks; EVAL section 2 schedule {sched_s:.2f} s; "
        f"chi2 {chi2:.4f}; {n_lm} landmarks against {seen} seen ({n_lm / seen:.3f}x); ATE rmse against the "
        f"ground truth {ate_gt['rmse']:.4f} m (odometry {ate_odo['rmse']:.4f} m, {ate_gt['rmse'] / ate_odo['rmse']:.3f}x), "
        f"against the known-association float64 optimum {ate_ref['rmse']:.4f} m (odometry {odo_ref['rmse']:.4f} m; "
        f"control chi2 {ctl['chi2']:.4f} in {ctl['iters']} LM iterations, {ctl_s:.2f} s on the host)")
    check(ate_gt["rmse"] < 0.7 * ate_odo["rmse"], f"ATE {ate_gt['rmse']:.4f} m is not below 0.7x the odometry's "
          f"{ate_odo['rmse']:.4f} m")
    check(0.6 * seen <= n_lm <= 1.8 * seen, f"{n_lm} landmarks against {seen} seen")
    caps = graphs.captures()[caps0:]
    stages = {}
    for c in caps:
        if ": " not in c.stage:  # a stage's key; a solve's pieces are named "<solve>: <piece>"
            stages[c.stage] = stages.get(c.stage, 0) + 1
    kept = [c for c in caps if c.kept and ": " in c.stage]
    say("slam2d", f"(a) captured over the app's and the family's {len(frames)}-pose runs: "
        f"{len(graphs._CHAINS) - chains0} solve chains kept ({len(kept)} graphs, "
        f"{sum(c.capture_ms for c in kept):.1f} ms, pool +{sum(c.pool_bytes for c in kept)} B), "
        f"{sum(stages.values())} stage keys {json.dumps(stages)} (pool "
        f"+{sum(c.pool_bytes for c in caps if ': ' not in c.stage)} B), {len([c for c in caps if not c.kept])} "
        f"CG-block graphs dropped at their solve's end; the device's graph pool {graphs._pool_bytes(device)} B")
    # the same frames with every stage and solve eager: the eager port, the graphs' yardstick
    tr2 = models.build("tracker2d", recipe="world2000", device=device)
    with graphs.mode("eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k, (delta, obs, info) in enumerate(frames):
            tr2.process_frame(delta, obs, info)
            if (k + 1) % 100 == 0:
                tr2.close_loops()
        track_e = time.perf_counter() - t0
        chi2_2, sched_e = host_s(lambda: eval_schedule(tr2))
    same = chi2 == chi2_2 and same_bits((est, tr2.trajectory()), (tr.landmarks, tr2.landmarks),
                                        (tr.lm_alive, tr2.lm_alive))
    say("slam2d", f"(a) the same frames and schedule with every stage and solve in eager mode: tracking loop "
        f"{track_e:.2f} s, {len(frames) / track_e:.2f} frames/s against {len(frames) / track_s:.2f} graphed "
        f"({track_e / track_s:.2f}x); schedule {sched_e:.2f} s against {sched_s:.2f} s graphed "
        f"({sched_e / sched_s:.2f}x); "
        f"chi2 {chi2_2:.4f}, {int(tr2.lm_alive.sum())} landmarks; trajectory, landmarks and chi2 bit-equal {same}")
    check(same, "the tracker2d family's graphed run differs from its eager rerun")
    ctx["tracker2d_fps"] = dict(graph=len(frames) / track_s, eager=len(frames) / track_e)

    # (b) the card against the CPU over the first frames, the same draws;
    # then the card's next frames under torch.profiler
    cfg = Tracker2DConfig(**models.TRACKER2D_RECIPES["world2000"])
    card, cpu = FeatureTracker2D(cfg, device=device), FeatureTracker2D(cfg, device="cpu")
    first_diff, pose_diffs = None, {}
    for k, (delta, obs, info) in enumerate(frames[:LOCKSTEP_FRAMES]):
        if not np.array_equal(card.process_frame(delta, obs, info), cpu.process_frame(delta, obs, info)):
            first_diff = k if first_diff is None else first_diff
        if (k + 1) % 100 == 0:
            pose_diffs[k + 1] = float(np.abs(card.trajectory() - cpu.trajectory())[:, :2].max())
    say("slam2d", f"(b) lockstep, {LOCKSTEP_FRAMES} frames on the card and the CPU: associations first differ at "
        f"frame {first_diff} (the first window solve ends frame {cfg.optimize_each_n - 1}); largest position "
        "difference " + ", ".join(f"{d:.3e} m after {f} frames" for f, d in pose_diffs.items()))
    check(first_diff is None or first_diff >= cfg.optimize_each_n, f"the card's associations part from the CPU's "
          f"at frame {first_diff}, before the first window solve")
    n = len(PROFILED_FRAMES)
    _, wall, dev, ops, syncs = profile_frames(lambda: [card.process_frame(*frames[j]) for j in PROFILED_FRAMES])
    say("slam2d", f"(b) the card's frames {PROFILED_FRAMES.start}-{PROFILED_FRAMES.stop - 1} under torch.profiler: "
        f"per frame wall {wall / n:.3f} ms, device {dev / n:.4f} ms ({100.0 * dev / wall:.1f}% busy), "
        f"{ops / n:.1f} device operations, {syncs / n:.2f} host syncs")
    _, wall, dev, ops, syncs = profile_frames(lambda: card.process_frame(*frames[PROFILED_FRAMES.stop]))
    say("slam2d", f"(b) frame {PROFILED_FRAMES.stop} with its window solve under torch.profiler: wall {wall:.3f} ms, "
        f"device {dev:.4f} ms ({100.0 * dev / wall:.1f}% busy), {ops} device operations, {syncs} host syncs")

    # (c) the other paths at test size
    for seed in (1, 2, 7):  # tests/test_validated_slam.py:69
        lms, circle = figure_world(seed)
        vt = FeatureTracker2D(Tracker2DConfig(odometry_is_good=True, optimize_each_n=0,
                                              incremental_guess_max_feature_distance=1.0,
                                              odom_info=(10.0, 10.0, 100.0)), device=device)
        st, v_s = host_s(lambda: run_validated_tracking(vt, drifted_frames(lms, circle), ValidatedSlamConfig(
            solve_every=20, propose_every=10, window=30, old_age=25, drift_base=15.0, min_inliers=4)))
        finish_window_closures(vt, window=30, step=15, old_age=25, radius=30.0, min_inliers=4)
        n, med = int(vt.lm_alive.sum()), float(np.median(vt.obs_edge_chi2()))
        say("slam2d", f"(c) validated tracking, figure world seed {seed}: {v_s:.2f} s, {st['closures']} closures, "
            f"{st['rollbacks']} rollbacks, {n} landmarks (true {len(lms)}), median observation chi2 {med:.4f}")
        check(n <= len(lms) + 1 and st["closures"] >= 1 and med < 1.0, f"validated tracking failed on seed {seed}")
    lms, circle = np.random.default_rng(3).uniform(-8, 8, (25, 2)), figure_world(0)[1]
    ct = FeatureTracker2D(Tracker2DConfig(odometry_is_good=True, optimize_each_n=0,
                                          incremental_guess_max_feature_distance=1.0), device=device)
    for delta, obs in drifted_frames(lms, circle, drift=(15.0, 9.0, 0.0), ramp=0, blind_ramp=False):
        ct.process_frame(delta, obs)
    before = int(ct.lm_alive.sum())
    merged = ct.close_loops_constellation(segment=40, dist_tol=0.3, inlier_threshold=0.8, min_inliers=6)
    say("slam2d", f"(c) close_loops_constellation, 15 m drift jump: {before} -> {int(ct.lm_alive.sum())} landmarks, "
        f"{merged} merged")
    check(before > 30 and merged >= 5, "the constellation closure merged too few")
    sim = simulate(SimulatorConfig(n_poses=160, n_landmarks=0, seed=11))
    a_idx, b_idx = np.arange(0, 100), np.arange(60, 160)
    Tb0 = sim.gt_poses[60]
    poses_b = np.stack([_se2_rel_np(Tb0, p) for p in sim.gt_poses[b_idx]])

    def sub_log(idx, poses):
        pos = {v: k for k, v in enumerate(idx)}
        es = [(pos[i], pos[j], z, w) for (i, j, z, w) in sim.odom_edges if i in pos and j in pos]
        return G2OLog(se2_ids=np.arange(len(idx)), se2_poses=np.asarray(poses, float),
                      edge_se2_ij=np.asarray([e[:2] for e in es]), edge_se2_meas=np.asarray([e[2] for e in es]),
                      edge_se2_info=np.asarray([e[3] for e in es]), fixed_ids=np.array([0]))

    res = graph_merge.match_graphs(sim.gt_poses[a_idx], poses_b, initial_guess=Tb0, gate=1.5, device=device)
    score = graph_merge.overlap_score(sim.gt_poses[a_idx], poses_b, res.transform, radius=0.8, device=device)
    merged_log = graph_merge.merge_graphs(sub_log(a_idx, sim.gt_poses[a_idx]), sub_log(b_idx, poses_b), res,
                                          device=device)
    g, _ = graph2d_from_log(merged_log, device=device)
    chi2m = pg.optimize_se2(g, iters=8, cg_iters=80)[1].chi2.cpu().numpy()
    say("slam2d", f"(c) match_graphs / merge_graphs, two halves of a 160-pose world: ok {res.ok}, {len(res.pairs)} "
        f"pairs, transform {np.round(res.transform, 4).tolist()} (truth {np.round(Tb0, 4).tolist()}), overlap "
        f"{score:.3f}; merged graph chi2 {chi2m[0]:.4f} -> {chi2m[-1]:.4f}")
    check(res.ok and len(res.pairs) >= 20 and score > 0.35 and chi2m[-1] <= chi2m[0] + 1e-3, "graph merge failed")
    for recipe in models.TRACKER2D_RECIPES:
        rt = models.build("tracker2d", recipe=recipe, device=device)
        for delta, obs, info in frames[:30]:
            rt.process_frame(delta, obs, info)
        say("slam2d", f"(c) models.build('tracker2d', recipe={recipe!r}): 30 frames, {rt.stats()}")
        check(rt.stats()["n_landmarks"] > 0, f"recipe {recipe} made no landmark")
    od = models.build("pwn_rgbd_odometry", rows=480, cols=640, device=device)
    m0, m1 = od.process_frame(ctx["d_ref"]), od.process_frame(ctx["d_cur"])
    say("slam2d", f"(c) models.build('pwn_rgbd_odometry', rows=480, cols=640) on the bench pair: keyframe "
        f"{m0['keyframe']}, then {m1['inliers']} inliers")
    check(m0["keyframe"] and m1["inliers"] > 0, "the pwn_rgbd_odometry family did not align the bench pair")
    say("slam2d", f"phase 13 took {time.perf_counter() - t13:.1f} s")


# phase 14: slice 5 at full size
GRID_WORLD = dict(n_poses=452, n_beams=360, room=12.0, max_range=16.0, odom_noise=(0.08, 0.05, 0.02),
                  seed=0)  # graphSE2.g2o's 452 scans (EVAL.md section 3), simulated
GRID_SLAM = dict(map_half_size=20.0, scans_per_submap=15, min_match_score=30.0)  # an 800x800 grid at 0.05 m
GRID_FIXTURE = dict(n_poses=120, n_beams=360, room=6.0, max_range=16.0, odom_noise=(0.08, 0.05, 0.02))
GRID_FIXTURE_SLAM = dict(map_half_size=8.4, scans_per_submap=12, min_match_score=30.0)  # tests/test_grid_slam.py:89
PLANE_BIG = dict(n_poses=1000, n_planes=60, per_pose=8, step=0.05, seed=9)  # 8,000 plane edges
BA_BIG = dict(n_poses=200, n_points=20000, per_point=8, seed=13)  # 160,000 observations (BAL Dubrovnik-88's order)
BA_CONTROL = dict(n_poses=30, n_points=1000, per_point=8, seed=21)  # against the dense float64 control


def plane_world(n_poses=5, planes=None, per_pose=None, noise=0.01, step=None, seed=9):
    """A plane-SLAM problem as tests/test_planes.py:77-127 builds one: world
    planes (canonical d >= 0; `planes` (L, 4), else the synthetic room's
    six), poses uniform in a box (or, with `step`, a random walk of twists
    of that scale), each pose observing `per_pose` random planes (all by
    default) with noise, an odometry chain from the truth, and noisy
    initial poses (pose 0 exact) and plane offsets. Returns (poses_gt (N,
    4, 4), planes_gt, poses7_init, planes_init, pp_edges, pl_edges) with
    edges (i, j, z, info)."""
    import numpy as np

    from g2o_frontend_tpu_torch.slam.simulator import _exp_se3
    from g2o_frontend_tpu_torch.slam.simulator import _T_to_pose7 as _pose7
    from g2o_frontend_tpu_torch.utils.synth import ROOM_PLANES

    rng = np.random.default_rng(seed)
    if planes is None:
        planes = [np.concatenate([-np.asarray(n), [-d]]) if d < 0 else np.concatenate([n, [d]])
                  for n, d in ROOM_PLANES]
    planes_gt = np.asarray(planes, np.float64)
    poses_gt = [np.eye(4)] if step else []
    while len(poses_gt) < n_poses:
        if step:
            poses_gt.append(poses_gt[-1] @ _exp_se3(rng.normal(0, step, 6)))
        else:
            poses_gt.append(_exp_se3(np.concatenate([rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.2, 0.2, 3)])))
    pl_edges, info4 = [], np.eye(4) * 100
    for i, T in enumerate(poses_gt):
        seen = range(len(planes_gt)) if per_pose is None else np.sort(rng.choice(len(planes_gt), per_pose, False))
        for l in seen:
            n, d = planes_gt[l, :3], planes_gt[l, 3]
            z = np.concatenate([T[:3, :3].T @ n, [d - n @ T[:3, 3]]])
            z[:3] += rng.normal(0, noise, 3)
            z[:3] /= np.linalg.norm(z[:3])
            z[3] += rng.normal(0, noise)
            pl_edges.append((i, int(l), z, info4))
    info6 = np.eye(6) * 100
    pp_edges = [(i, i + 1, _pose7(np.linalg.inv(poses_gt[i]) @ poses_gt[i + 1]), info6) for i in range(n_poses - 1)]
    poses7 = [_pose7(T if i == 0 else T @ _exp_se3(rng.normal(0, 0.05, 6))) for i, T in enumerate(poses_gt)]
    planes_init = planes_gt.copy()
    planes_init[:, 3] += rng.normal(0, 0.1, len(planes_gt))
    return np.asarray(poses_gt), planes_gt, np.asarray(poses7), planes_init, pp_edges, pl_edges


def random_planes(n, seed):
    """(n, 4) planes with unit normals uniform on the sphere and offsets in
    [1, 6) m."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3))
    return np.concatenate([nrm / np.linalg.norm(nrm, axis=1, keepdims=True), rng.uniform(1, 6, (n, 1))], 1)


def ba_world(n_poses=8, n_points=60, per_point=None, noise=0.01, init_noise=0.08, seed=13):
    """A BA problem as tests/test_ba.py:15-41 builds one: points uniform in
    a 6 m cube, poses with translations in [-1, 1] and rotations in [-0.3,
    0.3], each point observed from `per_point` random poses (all by default)
    as a local 3D point with noise and information 100 I, and noisy initial
    poses (pose 0 exact) and points. Returns (poses_gt (N, 4, 4), points_gt,
    poses7_init, points_init, (ij (M, 2), z (M, 3), info (M, 3, 3)))."""
    import numpy as np

    from g2o_frontend_tpu_torch.slam.simulator import _exp_se3
    from g2o_frontend_tpu_torch.slam.simulator import _T_to_pose7 as _pose7

    rng = np.random.default_rng(seed)
    points_gt = rng.uniform(-3, 3, (n_points, 3))
    poses_gt = np.asarray([_exp_se3(np.concatenate([rng.uniform(-1, 1, 3), rng.uniform(-0.3, 0.3, 3)]))
                           for _ in range(n_poses)])
    if per_point is None:
        ij = np.stack(np.meshgrid(np.arange(n_poses), np.arange(n_points), indexing="ij"), -1).reshape(-1, 2)
    else:
        who = np.argsort(rng.random((n_points, n_poses)), 1)[:, :per_point]
        ij = np.stack([who.reshape(-1), np.repeat(np.arange(n_points), per_point)], 1)
    R, t = poses_gt[ij[:, 0], :3, :3], poses_gt[ij[:, 0], :3, 3]
    z = np.einsum("kji,kj->ki", R, points_gt[ij[:, 1]] - t) + rng.normal(0, noise, (len(ij), 3))
    info = np.broadcast_to(np.eye(3) * 100, (len(ij), 3, 3)).copy()
    poses7 = np.asarray([_pose7(T if i == 0 else T @ _exp_se3(rng.normal(0, init_noise, 6)))
                         for i, T in enumerate(poses_gt)])
    points_init = points_gt + rng.normal(0, init_noise, points_gt.shape)
    return poses_gt, points_gt, poses7, points_init, (ij, z, info)


class Recorder:
    """Wraps `module.name` while in a `with` block: each call's arguments
    are kept (with `keep`) and the call is timed by a pair of CUDA events,
    read once the block has ended (`ms`)."""

    def __init__(self, module, name, keep=False):
        self.module, self.name, self.keep = module, name, keep
        self.calls, self.events = [], []

    def __enter__(self):
        import torch

        self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*args, **kw)
            e1.record()
            self.events.append((e0, e1))
            if self.keep:
                self.calls.append((args, kw, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def ms(self):
        import numpy as np
        import torch

        torch.cuda.synchronize()
        return np.asarray([e0.elapsed_time(e1) for e0, e1 in self.events])


def odometry_path(gt0, deltas):
    """The poses that integrate `deltas` from `gt0` (SE2, numpy)."""
    import numpy as np

    odo = [np.asarray(gt0, np.float64)]
    for d in deltas:
        a = odo[-1]
        c, s = np.cos(a[2]), np.sin(a[2])
        odo.append(np.array([a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], a[2] + d[2]]))
    return np.asarray(odo)


def drive_scans(drv, world, scans=None):
    """Feed a laser world's scans (all, or the range `scans`) to a grid or
    line SLAM driver with the odometry deltas; returns the host seconds,
    the device synchronised at both ends."""
    import numpy as np
    import torch

    ks = range(len(world["scans"])) if scans is None else scans
    if drv.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in ks:
        drv.process_scan(*world["scans"][k], world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32))
    if drv.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def cpu_slice5():
    """Phase 14 (a) and (b)'s runs on the CPU (in the worker): grid SLAM
    and line SLAM over the 452-scan world, each with the card's calls;
    the lines `extract_lines` gave for every scan, as numpy arrays."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.slam import line_slam as ls
    from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world

    cpu = torch.device("cpu")
    world = simulate_laser_world(LaserWorldConfig(**GRID_WORLD))
    slam = models.build("grid_slam", device=cpu, **GRID_SLAM)
    grid_s = drive_scans(slam, world)
    chi2 = slam.optimize(iters=10, cg_iters=100)
    grid = dict(s=grid_s, chi2=float(chi2), stats=slam.stats(), poses=np.asarray(slam.poses, np.float64))
    extract, kept = ls.extract_lines, []

    def keep(*args, **kw):
        out = extract(*args, **kw)
        kept.append({f: t.numpy() for f, t in out._asdict().items()})
        return out

    ls.extract_lines = keep
    try:
        drv = models.build("line_slam", device=cpu)
        run_s = drive_scans(drv, world)
        merged = drv.merge_landmarks()
        chi2_l, final_s = host_s(drv.optimize)
    finally:
        ls.extract_lines = extract
    lines = dict(s=run_s, merged=merged, chi2=float(chi2_l), final_s=final_s, stats=drv.stats(),
                 poses=np.asarray(drv.poses, np.float64), extracted=kept)
    return grid, lines


def edge_errors(slam, gt):
    """A grid-SLAM driver's scan-to-submap and loop-closure edges held
    against the ground-truth relative poses: the matches' median
    translation error and its median component along the true motion, and
    the loop closures off by more than 0.3 m."""
    import numpy as np

    from g2o_frontend_tpu_torch.slam.simulator import _rel

    out = {}
    for kind, info in (("match", slam.cfg.match_info), ("loop", slam.cfg.loop_info)):
        errs = np.asarray([(z - _rel(gt[i], gt[j]))[:2].tolist() + _rel(gt[i], gt[j])[:2].tolist()
                           for i, j, z, w in slam.edges if np.allclose(np.diag(w), info)]).reshape(-1, 4)
        along = np.sum(errs[:, :2] * errs[:, 2:], 1) / np.maximum(np.linalg.norm(errs[:, 2:], axis=1), 1e-9)
        out[kind] = (len(errs), np.linalg.norm(errs[:, :2], axis=1), along)
    (nm, em, am), (nl, el, _) = out["match"], out["loop"]
    return (f"{nm} scan-to-submap matches, translation error median {np.median(em):.4f} m, along the true motion "
            f"median {np.median(am):+.4f} m; {nl} loop closures, {int((el > 0.3).sum())} off by more than 0.3 m "
            f"(median {np.median(el) if nl else 0.0:.4f} m)")


def recheck_matches(calls, resolution, theta_step):
    """Every recorded `correlative_match_multires` call of the card rerun on
    CPU copies of its inputs: (equal poses, ties within one cell and one
    theta step, ties farther apart, the largest score difference relative
    to the CPU's). A tie is a pose other than the CPU's whose score equals
    the CPU's within rtol 1e-4; a pose with another score fails the phase."""
    from g2o_frontend_tpu_torch.laser import scan_matcher as sm

    equal, near, far, worst = 0, 0, [], 0.0
    for args, kw, res in calls:
        cpu = sm.correlative_match_multires(*(a.cpu() if hasattr(a, "cpu") else a for a in args),
                                            **{k: v.cpu() if hasattr(v, "cpu") else v for k, v in kw.items()})
        pc, pg = cpu.pose.double(), res.pose.cpu().double()
        sc, sg = float(cpu.score), float(res.score)
        worst = max(worst, abs(sg - sc) / max(abs(sc), 1e-30))
        if float((pc - pg).abs().max()) <= 1e-6:
            equal += 1
            continue
        check(abs(sg - sc) <= 1e-4 * abs(sc), f"a match of the card {pg.tolist()} (score {sg}) differs from the "
              f"CPU's {pc.tolist()} (score {sc})")
        if float((pc[:2] - pg[:2]).abs().max()) <= 1.01 * resolution and abs(float(pc[2] - pg[2])) <= 1.01 * theta_step:
            near += 1
        else:
            far.append((pg.tolist(), pc.tolist(), sc))
    return equal, near, far, worst


# The JAX package's LineSlam2D over phase 14's 452 scans on a CPU under
# JAX_PLATFORMS=cpu (tools/jax_line_slam_reference.py): 189 lines, 3,814
# observations, ATE 1.9133 m against the ground truth (the odometry's
# 0.8539 m); the port on the CPU gives 189, 3,774 and 1.3991 m (PERF.md
# section 6).
JAX_LINES = dict(n_lines=189, n_obs=3814, ate_rmse_m=1.9132882356643677)
# Phase 14 (b)'s bands on the card's line SLAM against the CPU's run (in
# the worker) and JAX_LINES. Runs that differ only in float32 rounding
# part on this world (apps/line_witness.py, PERF.md section 6): the JAX and
# the port's CPU runs, the card's, and the card's extraction with every
# solve on the CPU gave 189, 189, 204 and 197 lines, 3,814, 3,774, 3,774
# and 3,774 observations, ATE 1.913, 1.399, 1.538 and 3.171 m.
LINE_BAND = dict(
    lines=0.10,  # each reference's count +-10%: the rounding-only runs spread over 189-204 (+7.9%)
    obs=0.02,  # each reference's observations +-2%: they spread over 3,774-3,814 (1.1%)
    ate=2.5,  # at most 2.5x each reference's ATE: the rounding-only runs spread over 1.399-3.171 m (2.27x)
)


def lines_band(card, ate, cpu, ate_cpu):
    """Phase 14 (b)'s gate: the card's line and observation counts and ATE
    within LINE_BAND of the CPU's run and of the JAX package's."""
    refs = {"the CPU's": (cpu["n_lines"], cpu["n_obs"], ate_cpu),
            "the JAX package's": (JAX_LINES["n_lines"], JAX_LINES["n_obs"], JAX_LINES["ate_rmse_m"])}
    for name, (lines, obs, ate_ref) in refs.items():
        ok = (abs(card["n_lines"] - lines) <= LINE_BAND["lines"] * lines
              and abs(card["n_obs"] - obs) <= LINE_BAND["obs"] * obs and ate <= LINE_BAND["ate"] * ate_ref)
        say("slice5", f"(b) the card's line SLAM against {name} run: lines {card['n_lines']} vs {lines} (limit "
            f"+-{LINE_BAND['lines']:.0%}), observations {card['n_obs']} vs {obs} (+-{LINE_BAND['obs']:.0%}), ATE "
            f"{ate:.4f} vs {ate_ref:.4f} m (limit {LINE_BAND['ate']}x): within {ok}")
        check(ok, f"the card's line SLAM is outside its band around {name} run")


def grid_turns(device, world, first, first_calls, first_chi2, since):
    """Grid SLAM over `world` again, in turns (eager, graph, graph, eager):
    "eager" runs every stage and solve as its eager body, "graph" replays
    the matching, map and solve graphs that `first` (the phase's first
    run, its matches `first_calls`) captured. Every run bit-equal to the
    first in poses, edges, chi2 and each match's pose, score and scores a
    rotation; scans/s of each; the stage keys captured and their pool."""
    import numpy as np

    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.laser import matcher_refine as mr
    from g2o_frontend_tpu_torch.laser import scan_matcher as sm
    from g2o_frontend_tpu_torch.slam import grid_slam as gs
    from g2o_frontend_tpu_torch.utils import graphs

    def run(mode):
        drv = models.build("grid_slam", device=device, **GRID_SLAM)
        with graphs.mode(mode), Recorder(gs, "correlative_match_multires", keep=True) as rec:
            secs = drive_scans(drv, world)
            chi2 = drv.optimize(iters=10, cg_iters=100)
        return drv, secs, chi2, [out for _, _, out in rec.calls]

    want = [out for _, _, out in first_calls]
    rates, same = {"graph": [], "eager": []}, True
    for mode in ("eager", "graph", "graph", "eager"):
        drv, secs, chi2, outs = run(mode)
        rates[mode].append(len(world["scans"]) / secs)
        same = (same and chi2 == first_chi2 and np.array_equal(np.asarray(drv.poses), np.asarray(first.poses))
                and len(drv.edges) == len(first.edges) and len(outs) == len(want)
                and all((i, j) == (i2, j2) and np.array_equal(z, z2) for (i, j, z, _), (i2, j2, z2, _) in
                        zip(drv.edges, first.edges))
                and all(same_bits(*zip(a, b)) for a, b in zip(outs, want)))
    caps = [c for c in graphs.captures()[since:] if c.stage in ("correlative_match_multires", "build_likelihood_map",
                                                                 "gradient_refine", "correlative_match")]
    keys = {st.name: len(st._graphs) for st in (sm._MULTIRES, sm._LIKELIHOOD, mr._REFINE) if st._graphs}
    g, e = max(rates["graph"]), max(rates["eager"])
    say("slice5", f"(a) grid SLAM in turns (eager, graph, graph, eager), {len(world['scans'])} scans and the solve: "
        f"graph {g:.2f} scans/s ({', '.join(f'{r:.2f}' for r in rates['graph'])}), eager {e:.2f} scans/s "
        f"({', '.join(f'{r:.2f}' for r in rates['eager'])}), {g / e:.2f}x; every run bit-equal to the first in "
        f"poses, edges, chi2 and its {len(want)} matches' poses and scores: {same}; stage keys {keys}, captured in "
        f"{sum(c.capture_ms for c in caps):.1f} ms, pool "
        f"+{sum(c.pool_bytes for c in caps)} B, static inputs {sum(c.input_bytes for c in caps)} B")
    check(same, "grid SLAM graphed differs from its eager mode")
    return dict(graph=g, eager=e)


def phase_slice5(ctx, out_dir):
    """Phase 14: slice 5 (no kernel) at full size. (a) Grid SLAM over a
    simulated laser world at graphSE2.g2o's 452 scans (800x800 grids at
    0.05 m), every correlative match of the card recorded and rerun on the
    CPU, the run repeated graphed and eager in turns, bit for bit
    (`grid_turns`), the same scans through the port on the CPU (in the worker, since
    phase 12), the JAX package's ground-truth fixture (its ATE gate), 20
    scans under torch.profiler; (b) line SLAM over the same scans, and on
    the CPU in the worker; (c)
    the plane graph, 1,000 poses and 60 planes (8,000 plane edges), its
    first LM iterations on the CPU; (d) BA, 200 poses and 20,000 points
    (160,000 observations), its first LM iterations on the CPU, and a
    30-pose problem against the float64 control. The line, plane and BA
    solves and the extraction run graphed against their eager mode."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.laser import line_extraction as tle
    from g2o_frontend_tpu_torch.slam import grid_slam as gs
    from g2o_frontend_tpu_torch.slam import line_slam as ls
    from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world
    from g2o_frontend_tpu_torch.solvers import ba as tba
    from g2o_frontend_tpu_torch.solvers import plane_slam as tps
    from g2o_frontend_tpu_torch.solvers.control import control_optimize_ba
    from g2o_frontend_tpu_torch.utils import graphs
    from g2o_frontend_tpu_torch.utils.evaluation import ate_xy

    device, t14 = ctx["device"], time.perf_counter()
    cpu = torch.device("cpu")

    # (a) grid SLAM, the main path of this slice
    world = simulate_laser_world(LaserWorldConfig(**GRID_WORLD))
    gt = world["gt_poses"].astype(np.float64)
    odo = odometry_path(gt[0], world["odom_deltas"])
    n = len(world["scans"])
    slam = models.build("grid_slam", device=device, **GRID_SLAM)
    since = len(graphs.captures())
    with Recorder(gs, "correlative_match_multires", keep=True) as matches, Recorder(gs, "build_likelihood_map") as maps:
        track_s = drive_scans(slam, world)
        chi2, opt_s = host_s(lambda: slam.optimize(iters=10, cg_iters=100))
    match_ms, map_ms = matches.ms(), maps.ms()
    st = slam.stats()
    est = np.asarray(slam.poses, np.float64)
    ate, ate_odo = ate_xy(est[:, :2], gt[:, :2])["rmse"], ate_xy(odo[:, :2], gt[:, :2])["rmse"]
    spec = slam._spec()
    say("slice5", f"(a) grid SLAM, {n} scans, {spec.rows}x{spec.cols} grids at {spec.resolution} m: {track_s:.2f} s, "
        f"{n / track_s:.2f} scans/s; {len(match_ms)} matches, median {np.median(match_ms):.3f} ms (CUDA events); "
        f"{len(map_ms)} map rebuilds, median {np.median(map_ms):.3f} ms; optimize(iters=10, cg_iters=100) "
        f"{opt_s:.3f} s, chi2 {chi2:.4f}; {st['n_submaps']} submaps, {st['n_edges']} edges; ATE rmse against the "
        f"ground truth {ate:.4f} m (odometry {ate_odo:.4f} m, {ate / ate_odo:.3f}x)")
    check(np.isfinite(chi2) and st["n_submaps"] == 1 + n // slam.cfg.scans_per_submap, "grid SLAM failed")
    say("slice5", "(a) its edges against the ground truth: " + edge_errors(slam, gt))
    step = np.deg2rad(slam.cfg.theta_step_deg)
    (equal, near, far, worst), re_s = host_s(lambda: recheck_matches(matches.calls, spec.resolution, step))
    say("slice5", f"(a) the card's {len(matches.calls)} matches rerun on the CPU ({re_s:.1f} s): {equal} give the "
        f"CPU's pose, {near} ties within one cell and one theta step, {len(far)} ties farther apart "
        f"{[(np.round(g, 4).tolist(), np.round(c, 4).tolist(), sc) for g, c, sc in far]} (card, CPU, score); "
        f"scores within {worst:.2e} of the CPU's")
    check(equal >= 0.99 * len(matches.calls), f"only {equal} of {len(matches.calls)} matches give the CPU's pose")
    grid_cpu, lines_cpu = ctx["slice5_cpu"].get() if "slice5_cpu" in ctx else cpu_slice5()
    ate_cpu = ate_xy(grid_cpu["poses"][:, :2], gt[:, :2])["rmse"]
    say("slice5", f"(a) the same scans on the CPU (the worker process, since phase 12): {grid_cpu['s']:.2f} s, "
        f"{grid_cpu['stats']}, chi2 {grid_cpu['chi2']:.4f}, ATE {ate_cpu:.4f} m; largest position difference to the "
        f"card {np.abs(est - grid_cpu['poses'])[:, :2].max():.3e} m")
    check(grid_cpu["stats"]["n_submaps"] == st["n_submaps"], "the card and the CPU made different submap counts")
    fixture = simulate_laser_world(LaserWorldConfig(**GRID_FIXTURE))
    fix = models.build("grid_slam", device=device, **GRID_FIXTURE_SLAM)
    fix_s = drive_scans(fix, fixture)
    fix.optimize(iters=10, cg_iters=100)
    fgt = fixture["gt_poses"].astype(np.float64)
    f_ate = ate_xy(np.asarray(fix.poses, np.float64)[:, :2], fgt[:, :2])["rmse"]
    f_odo = ate_xy(odometry_path(fgt[0], fixture["odom_deltas"])[:, :2], fgt[:, :2])["rmse"]
    say("slice5", f"(a) the JAX package's ground-truth fixture (tests/test_grid_slam.py:89, {len(fgt)} scans, "
        f"{fix._spec().rows}x{fix._spec().cols}): {fix_s:.2f} s, ATE {f_ate:.4f} m against the odometry's {f_odo:.4f} m "
        f"({f_ate / f_odo:.3f}x)")
    check(f_ate < 0.75 * f_odo and f_ate < 0.35, f"grid SLAM ATE {f_ate:.4f} m on the fixture is not below 0.75x the "
          f"odometry's {f_odo:.4f} m and 0.35 m")
    ctx["grid_scans_s"] = grid_turns(device, world, slam, matches.calls, chi2, since)
    warm = models.build("grid_slam", device=device, **GRID_SLAM)
    drive_scans(warm, world, range(40))
    _, wall, dev, ops, syncs = profile_frames(lambda: drive_scans(warm, world, range(40, 60)))
    say("slice5", f"(a) scans 40-59 under torch.profiler: per scan wall {wall / 20:.3f} ms, device {dev / 20:.4f} ms "
        f"({100.0 * dev / wall:.1f}% busy), {ops / 20:.1f} device operations, {syncs / 20:.2f} host syncs")

    # (b) line SLAM over the same scans, twice on the card here and on the CPU in the worker
    drv = models.build("line_slam", device=device)
    launches = ctx.setdefault("segment_sum_launches", {})

    def line_run():
        with Recorder(ls, "extract_lines", keep=True) as ext_, \
                Recorder(ls, "optimize_line_graph", keep=True) as solves_:
            run_s_ = drive_scans(drv, world)
            merged_ = drv.merge_landmarks()
            chi2_l_, final_s_ = host_s(drv.optimize)
        return ext_, solves_, run_s_, merged_, chi2_l_, final_s_

    ext, solves, run_s, merged, chi2_l, final_s = counted(line_run, launches, "line_slam")
    extracted = [out for _, _, out in ext.calls]
    # (e) holds the segment sums of the middle extraction and of the last solve, run eagerly (a replay calls
    # no wrapper)
    recorded = ctx.setdefault("sums_recorded", [])
    e_args, e_kw, _ = ext.calls[len(ext.calls) // 2]
    s_args, s_kw, _ = solves.calls[-1]
    with graphs.mode("eager"):
        recorded += [("line extraction", "line_slam", c)
                     for c in record_sums(lambda: ls.extract_lines(*e_args, **e_kw))]
        recorded += [("line solve", "line_slam", c)
                     for c in record_sums(lambda: ls.optimize_line_graph(*s_args, **s_kw))]
        eager_ext = [ls.extract_lines(*a, **k) for a, k, _ in ext.calls]
    same_ext = all(same_bits(*zip(a, b)) for a, b in zip(extracted, eager_ext))
    ext_row = graph_turns(ctx, f"extract_lines, {len(e_args[0])} beams", lambda: ls.extract_lines(*e_args, **e_kw),
                          lambda: tle._extract_lines(*e_args), 30)
    say("slice5", f"(b) extract_lines: the {len(extracted)} scans' graphed line sets bit-equal to their eager "
        f"extraction {same_ext}; one scan graph {ext_row['graph_ms']:.4f} ms, eager {ext_row['eager_ms']:.4f} ms")
    check(same_ext, "a graphed extract_lines differs from its eager body")
    _, solve_lines, solve_ms = graphed_solve(
        f"(b) optimize_line_graph, the last solve's graph ({s_args[0].poses.shape[0]} pose rows, "
        f"{s_args[0].lines.shape[0]} line rows, {s_args[0].pl_ij.shape[0]} observation rows; {s_kw})",
        lambda: ls.optimize_line_graph(*s_args, **s_kw),
        lambda: ls.optimize_line_graph(*s_args, **{**s_kw, "iters": 1}), lambda t: len(t) - 1)
    for line in solve_lines:
        say("slice5", line)
    ctx.setdefault("solve_ms", {})["line SLAM's last solve"] = solve_ms
    ate_l = ate_xy(np.asarray(drv.poses, np.float64)[:, :2], gt[:, :2])["rmse"]
    say("slice5", f"(b) line SLAM on cuda: {run_s:.2f} s for {n} scans ({n / run_s:.2f} scans/s; a solve every "
        f"{drv.cfg.optimize_each_n}); extract_lines median {np.median(ext.ms()):.3f} ms, {len(solves.events)} solves, "
        f"median {np.median(solves.ms()) / 1000.0:.3f} s a solve (CUDA events); merge_landmarks merged {merged}, "
        f"final optimize {final_s:.3f} s, chi2 {chi2_l:.4f}; {drv.stats()}; ATE rmse {ate_l:.4f} m (odometry "
        f"{ate_odo:.4f} m)")
    lc = lines_cpu
    say("slice5", f"(b) line SLAM on cpu (the worker process): {lc['s']:.2f} s for {n} scans ({n / lc['s']:.2f} "
        f"scans/s); merge_landmarks merged {lc['merged']}, final optimize {lc['final_s']:.3f} s, chi2 "
        f"{lc['chi2']:.4f}; {lc['stats']}; ATE rmse {ate_xy(lc['poses'][:, :2], gt[:, :2])['rmse']:.4f} m")
    same = [bool(np.array_equal(a.mask.cpu().numpy(), b["mask"]) and np.array_equal(a.n_points.cpu().numpy(),
                                                                                     b["n_points"]))
            for a, b in zip(extracted, lc["extracted"])]
    geo = max(float(np.abs(getattr(a, f).cpu().numpy() - b[f]).max()) for a, b, eq in
              zip(extracted, lc["extracted"], same) if eq for f in ("p0", "p1", "normal", "rho"))
    say("slice5", f"(b) extract_lines on the card against the CPU, the same {len(same)} scans: {sum(same)} with the "
        f"same lines (mask and point counts), endpoints, normals and rho within {geo:.2e} there; segment-sum kernel "
        f"launches {launches['line_slam']}")
    check(np.isfinite(chi2_l) and drv.stats()["n_lines"] > 0, "line SLAM failed")
    def same_run(d, m, c):
        return (drv.stats() == d.stats() and merged == m and chi2_l == c
                and [(p, l) for p, l, _, _ in drv.pl_edges] == [(p, l) for p, l, _, _ in d.pl_edges]
                and same_bits(*[(a[2], b[2]) for a, b in zip(drv.pl_edges, d.pl_edges)],
                              (np.asarray(drv.poses), np.asarray(d.poses)), (drv.lines, d.lines)))

    drv2 = models.build("line_slam", device=device)
    run2_s = drive_scans(drv2, world)
    merged2, chi2_l2 = drv2.merge_landmarks(), drv2.optimize()
    same = same_run(drv2, merged2, chi2_l2)
    say("slice5", f"(b) line SLAM a second time on the card ({run2_s:.2f} s, {n / run2_s:.2f} scans/s): "
        f"{drv2.stats()}, merged {merged2}, chi2 {chi2_l2:.4f}; lines, observations (pose, line, measurement), "
        f"poses and chi2 bit-equal {same}")
    check(same, "two card runs of line SLAM differ")
    drv3 = models.build("line_slam", device=device)
    with graphs.mode("eager"):
        run3_s = drive_scans(drv3, world)
        merged3, chi2_l3 = drv3.merge_landmarks(), drv3.optimize()
    same = same_run(drv3, merged3, chi2_l3)
    say("slice5", f"(b) line SLAM with every stage and solve in eager mode: {run3_s:.2f} s, {n / run3_s:.2f} scans/s "
        f"against {n / run2_s:.2f} graphed ({run3_s / run2_s:.2f}x); bit-equal to the graphed runs {same}")
    check(same, "line SLAM's graphed run differs from its eager rerun")
    ctx["line_scans_s"] = dict(graph=n / run2_s, eager=n / run3_s)
    lines_band(drv.stats(), ate_l, lc["stats"], ate_xy(lc["poses"][:, :2], gt[:, :2])["rmse"])

    # (c) the plane graph
    planes = random_planes(PLANE_BIG["n_planes"], PLANE_BIG["seed"] + 1)
    _, _, poses7, planes_init, pp, pl = plane_world(n_poses=PLANE_BIG["n_poses"], planes=planes,
                                                    per_pose=PLANE_BIG["per_pose"], step=PLANE_BIG["step"],
                                                    seed=PLANE_BIG["seed"])
    g = tps.make_plane_graph(poses7, planes_init, pp, pl, device=device)
    (gp_, tr), lines, solve_ms = graphed_solve(
        f"(c) optimize_plane_graph, {len(poses7)} poses, {len(planes)} planes, {len(pl)} plane edges, {len(pp)} "
        f"odometry edges (padded to {g.poses.shape[0]}, {g.planes.shape[0]}, {g.pl_ij.shape[0]}, "
        f"{g.pp_ij.shape[0]} rows), iters=15, cg_iters=60", lambda: tps.optimize_plane_graph(g, iters=15, cg_iters=60),
        lambda: tps.optimize_plane_graph(g, iters=1, cg_iters=60), lambda t: len(t) - 1)
    for line in lines:
        say("slice5", line)
    ctx.setdefault("solve_ms", {})["plane graph"] = solve_ms
    _, tr_cpu = tps.optimize_plane_graph(tps.make_plane_graph(poses7, planes_init, pp, pl, device=cpu), iters=3,
                                         cg_iters=60)
    ok, rel = trace_close(tr[:4], tr_cpu, 1e-3)
    say("slice5", f"(c) trace {[round(float(x), 4) for x in tr]}; the first 3 LM iterations on the CPU within {rel:.2e}")
    check(ok and float(tr[-1]) < 0.05 * float(tr[0]), "the plane graph's trace differs from the CPU's or stalled")

    # (d) BA
    _, _, poses7, points_init, obs = ba_world(**BA_BIG)
    ba = tba.make_ba_problem(poses7, points_init, obs, device=device)
    ctx["ba_big"] = (poses7, points_init, obs)  # for phase 15
    (ba1, tr), lines, solve_ms = graphed_solve(
        f"(d) optimize_ba, {len(poses7)} poses, {len(points_init)} points, {len(obs[0])} observations (padded to "
        f"{ba.poses.shape[0]}, {ba.points.shape[0]}, {ba.obs_ij.shape[0]} rows), iters=10, cg_iters=50",
        lambda: tba.optimize_ba(ba, iters=10, cg_iters=50), lambda: tba.optimize_ba(ba, iters=1, cg_iters=50),
        lambda t: len(t) - 1, launches=launches, key="ba")
    for line in lines:
        say("slice5", line)
    say("slice5", f"(d) segment-sum kernel launches of the first solve {launches['ba']} (replays counted)")
    ctx.setdefault("solve_ms", {})["BA"] = solve_ms
    _, tr_cpu = tba.optimize_ba(tba.make_ba_problem(poses7, points_init, obs, device=cpu), iters=2, cg_iters=50)
    ok, rel = trace_close(tr[:3], tr_cpu, 1e-3)
    say("slice5", f"(d) trace {[round(float(x), 4) for x in tr]}; the first 2 LM iterations on the CPU within {rel:.2e}")
    check(ok and float(tr[-1]) < 0.01 * float(tr[0]), "BA's trace differs from the CPU's or stalled")
    _, _, poses7, points_init, obs = ba_world(**BA_CONTROL)
    _, tr = tba.optimize_ba(tba.make_ba_problem(poses7, points_init, obs, device=device), iters=10, cg_iters=50)
    ctl, ctl_s = host_s(lambda: control_optimize_ba(tba.make_ba_problem(poses7, points_init, obs, device=cpu)))
    say("slice5", f"(d) {len(poses7)} poses, {len(points_init)} points, {len(obs[0])} observations: chi2 "
        f"{float(tr[-1]):.4f} against the float64 control's {ctl['chi2']:.4f} ({float(tr[-1]) / ctl['chi2']:.6f}x; "
        f"control {ctl['iters']} LM iterations, {ctl_s:.2f} s on the host)")
    check(float(tr[-1]) <= 1.01 * ctl["chi2"], "BA is not within 1.01x the float64 control")

    # (e) the segment-sum kernel on the sums of phase 12's Schur solve and (d)'s BA
    ctx["segment_sum"] = phase_segment_sum(ctx, ba)
    say("slice5", f"phase 14 took {time.perf_counter() - t14:.1f} s")


def record_sums(fn):
    """fn() with `ops.segment_sum` wrapped: the (values, SegmentIndex) of
    the first call for each index and row shape, in call order."""
    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    calls, original = {}, ss.segment_sum

    def wrapped(values, seg):
        calls.setdefault((id(seg), tuple(values.shape[1:])), (values, seg))
        return original(values, seg)

    ss.segment_sum = wrapped
    try:
        fn()
    finally:
        ss.segment_sum = original
    return list(calls.values())


def long_segments(seg, lay):
    """(the rows from which a segment of `seg` takes the segment-sum
    kernel's long path under the layout `lay`, the number that do): a host
    read, for reports."""
    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    if seg.n == 0:
        return lay.long_min, 0
    lengths = seg.sorted_lengths.cpu()
    threshold = ss.long_threshold(lengths, lay)
    return threshold, int((lengths >= threshold).sum())


def index_in_graph(index, values, n):
    """A `SegmentIndex` over `index` built and summed inside a CUDA graph
    capture, the graph replayed, then the captured index summed again
    outside the capture: whether each equals the eager sum bit for bit."""
    import torch

    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    eager = ss.segment_sum(values, ss.SegmentIndex(index, n))
    side = torch.cuda.Stream()  # the warm-up a capture asks for, on a side stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.segment_sum(values, ss.SegmentIndex(index, n))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        seg = ss.SegmentIndex(index, n)
        captured = ss.segment_sum(values, seg)
    graph.replay()
    after = ss.segment_sum(values, seg)
    torch.cuda.synchronize()
    return dict(replayed=same_bits((captured, eager)), after_capture=same_bits((after, eager)))


def turns(fns, like, n=50):
    """`graph_ms` of each of `fns` in turns, forward then backward (for
    three: a, b, c, c, b, a), each the lesser of its two, so that a drift
    of the card's clock falls on all of them; n calls a graph."""
    from g2o_frontend_tpu_torch.utils.profiling import graph_ms

    first = [graph_ms(f, like, n) for f in fns]
    second = [graph_ms(f, like, n) for f in reversed(fns)][::-1]
    return [min(a, b) for a, b in zip(first, second)]


def phase_segment_sum(ctx, ba):
    """Phase 14 (e): the segment-sum kernel against its plain version on the
    distinct sums of every path that launches it: one LM iteration of phase
    12's Schur solve and of (d)'s BA, one line-SLAM extraction and solve
    ((b)), one fusion and its voxels at 0.02 and 0.1 m (phase 11 (b), (c)),
    and the first Schur sum as float64. For each distinct (index, row
    shape): `segment_sum` (the kernel) and the previous design each equal
    bit for bit to the CPU's index_add_ on CPU copies of the inputs, two
    launches bit-equal; the two timed by CUDA graph replays in turns with
    the atomic index_add_ of the live rows into n rows (the one PyTorch
    call that computes the same sum), beside the plain version and the
    bound, which counts only the live rows (those of the dump slot are
    never read). Then an
    index built and summed inside a graph capture (`index_in_graph`) on a
    line-SLAM and a Schur sum. Returns the kernel row's numbers: those of
    the call with the most bytes, and every call's."""
    import torch

    from g2o_frontend_tpu_torch.ops import segment_sum as ss
    from g2o_frontend_tpu_torch.solvers import ba as tba
    from g2o_frontend_tpu_torch.solvers import schur_pcg as sp
    from g2o_frontend_tpu_torch.utils import graphs
    from g2o_frontend_tpu_torch.utils.profiling import graph_ms

    t0 = time.perf_counter()
    g = ctx["victoria"]["g"]
    with graphs.mode("eager"):  # a replayed graph calls no wrapper: record the sums where they run
        recorded = [("Schur", "schur", c) for c in record_sums(lambda: sp.optimize_se2_schur(g, **{**SCHUR_CAPS,
                                                                                                    "iters": 1}))]
        recorded += [("BA", "ba", c) for c in record_sums(lambda: tba.optimize_ba(ba, iters=1, cg_iters=50))]
    recorded += ctx.pop("sums_recorded", [])
    values, seg = recorded[0][2]
    recorded.append(("Schur (as float64)", "schur", (values.double(), seg)))
    launches = ctx["segment_sum_launches"]
    torch.cuda.synchronize()
    rows, err = [], 0.0
    for path, key, (values, seg) in recorded:
        E, C, n = values.shape[0], values[0].numel(), seg.n
        k1, k2 = ss.segment_sum(values, seg), ss.segment_sum(values, seg)
        prev = ss._segment_sum_previous(values, seg)
        plain = ss.segment_sum_reference(values.cpu(), ss.SegmentIndex(seg.index.cpu(), n))
        equal = dict(twice=same_bits((k1, k2)), cpu=same_bits((k1, plain)), previous=same_bits((prev, plain)))
        err = max(err, float((k1.cpu() - plain).abs().max()) if k1.numel() else 0.0)
        v = values.contiguous()
        # the rows sent to the dump slot (masked edges, BA's padded
        # observations) are never read by the kernel: the bound and the
        # atomic index_add_ count only the live rows
        live = seg.index < n
        E_live = int(seg.offsets[n])
        v_live, index_live = v[live].contiguous(), seg.index[live].contiguous()
        k_ms, prev_ms, lib_ms = turns([lambda: ss.segment_sum(v, seg), lambda: ss._segment_sum_previous(v, seg),
                                       lambda: v.new_zeros((n,) + v.shape[1:]).index_add_(0, index_live, v_live)], v)
        plain_ms = graph_ms(lambda: ss.segment_sum_reference(v, seg), v, 20)
        nbytes = (E_live * C + n * C) * v.element_size() + E_live * 4 + (n + 1) * 4
        bound_ms = nbytes / 3.35e12 * 1e3
        lengths = seg.offsets[1:] - seg.offsets[:-1]
        lay = ss.layout(E, n, C, v.element_size())
        threshold, n_long = long_segments(seg, lay)
        longest = int(lengths.max()) if n else 0
        say("slice5", f"(e) segment_sum on {path}'s {E} rows ({E_live} live) x {C} {str(v.dtype)[6:]} into {n} "
            f"segments (longest {longest}; {lay.long_blocks} long + {lay.short_blocks} short blocks, {n_long} "
            f"segments long from {threshold} rows, {lay.outputs_per_thread} output(s) a thread, "
            f"{lay.rows_per_chunk} rows a chunk, {lay.copy_bytes}-byte copies): kernel {k_ms:.6f} ms, previous "
            f"design {prev_ms:.6f} ms ({k_ms / prev_ms:.3f}x), atomic index_add_ of the live rows {lib_ms:.6f} ms "
            f"({k_ms / lib_ms:.3f}x), plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({nbytes} B, "
            f"{100.0 * bound_ms / k_ms:.1f}% of it); "
            f"the path's launches {launches[key]}; equal to the CPU's index_add_ bit for bit {equal}")
        check(all(equal.values()), f"the segment-sum kernel differs from its plain version on {path}'s {E} x {C} sum")
        rows.append(dict(path=path, launches=launches[key], rows=E, live_rows=E_live, columns=C, segments=n,
                         longest=longest,
                         long_segments=n_long, ms=k_ms, previous_ms=prev_ms, library_ms=lib_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, nbytes=nbytes))
    for path in ("line extraction", "Schur (as float64)"):  # the first sum of each
        values, seg = next(c for p, _, c in recorded if p == path)
        captured = index_in_graph(seg.index, values, seg.n)
        say("slice5", f"(e) {path}'s index built and summed inside a CUDA graph capture: {captured}")
        check(all(captured.values()), f"an index built inside a CUDA graph capture sums otherwise ({path})")
    top = max(rows, key=lambda r: r["nbytes"])
    slower = [r for r in rows if r["ms"] > 1.05 * r["previous_ms"]]
    say("slice5", f"(e) {len(rows)} distinct sums, every one bit-equal to the CPU in both designs; "
        f"{len(slower)} more than 5% slower than the previous design "
        f"{[(r['path'], r['rows'], r['columns'], round(r['ms'] / r['previous_ms'], 3)) for r in slower]}; the row's "
        f"call: {top['path']}'s {top['rows']} x {top['columns']} into {top['segments']}; (e) took "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(err=err, top=top, calls=rows)


# Phase 15: slice 6, the distributed solvers, D = 8 shards stacked on the
# card (one H100 holds every shard; NCCL runs at world size 1 in (e)). The
# caps of (b)-(d): the gates are met inside them on the CPU at the same
# sizes (PERF.md records the rehearsal). The CPU repeats run the first LM
# iterations only.
MESH_D = 8
PART_CAPS = dict(iters=10, cg_iters=60)  # partitioned jacobi / chain, as phase 12 (c)
SCHUR_PART_CAPS = SCHUR_CAPS
SE3_SPIKE_CAPS = dict(iters=25, cg_iters=100, precond="spike")  # bench.py:345-373
SE2_SHARD_CAPS = dict(iters=10, cg_iters=60)
SE3_SHARD_CAPS = dict(iters=10, cg_iters=100)
BA_SHARD_CAPS = dict(iters=10, cg_iters=50)  # phase 14 (d)
CPU_LM = 2  # LM iterations repeated on the CPU
NCCL_LM = 2  # LM iterations of each (e) run


def random_ghosts(n_dev, B, G, seed):
    """Random ghost directories, each shard reading up to G remote poses
    (tests/test_halo.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_dev):
        pool = [p for p in range(n_dev * B) if not s * B <= p < (s + 1) * B]
        out.append(sorted(rng.choice(pool, size=int(rng.integers(0, G + 1)), replace=False).tolist()))
    return out


def chain_shards(n_dev, d=3, B=8, m=1, seed=0):
    """A random SPD block-tridiagonal chain of n_dev * B blocks cut into
    n_dev shards, and m right-hand sides: ((L, D, U, U_bnd, R) float32 with
    the shard axis in front, R (n_dev, B, d, m); the dense float64 matrix)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_dev * B
    D = np.stack([a @ a.T + (d + 2.0) * np.eye(d) for a in rng.normal(size=(n, d, d))])
    U = rng.normal(0, 0.4, (n, d, d))
    A = np.zeros((n * d, n * d))
    U_loc, L_loc, U_bnd = np.zeros((n_dev, B, d, d)), np.zeros((n_dev, B, d, d)), np.zeros((n_dev, d, d))
    for i in range(n):
        A[i * d:(i + 1) * d, i * d:(i + 1) * d] = D[i]
        if i + 1 < n:
            A[i * d:(i + 1) * d, (i + 1) * d:(i + 2) * d], A[(i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] = U[i], U[i].T
            s, k = divmod(i, B)
            if k < B - 1:
                U_loc[s, k], L_loc[s, k + 1] = U[i], U[i].T
            else:
                U_bnd[s] = U[i]
    R = rng.normal(size=(n_dev, B, d, m))
    return [a.astype(np.float32) for a in (L_loc, D.reshape(n_dev, B, d, d), U_loc, U_bnd, R)], A


def count_ops(fn):
    """(fn(), the aten operations it dispatched that are not views: each a
    host dispatch and, on the card, a kernel launch or a copy)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Counter.n += 1
            return func(*args, **(kwargs or {}))

    with Counter():
        out = fn()
    return out, Counter.n


def ops_per_cg(solve):
    """Operations of one CG iteration of `solve(cg_iters)` (one LM
    iteration), as the slope between 4 and 2 CG iterations."""
    return (count_ops(lambda: solve(4))[1] - count_ops(lambda: solve(2))[1]) / 2


def parallel_solve(label, fn, one_iteration, lm_of, stops=False):
    """A distributed solve through `graphed_solve` (graphed four times, the
    chain captured at the second; eager once; all bit-equal; graph against
    eager by CUDA events), its host reads held to one a CG block and one an
    LM iteration (the eager run's reads give its CG iterations: one a step,
    one more a solve's CG loop, and the reports), its eager operations a CG
    iteration (`ops_per_cg`); the lines printed. Returns (the result, the
    timing row). `lm_of` gives a result's LM iterations."""
    from g2o_frontend_tpu_torch.solvers import pcg
    from g2o_frontend_tpu_torch.utils import graphs

    last = []

    def solve():
        last[:] = [fn()]
        return last[0]

    out, lines, row = graphed_solve(label, solve, one_iteration, lambda _: lm_of(last[0]), eager_turns=1)
    lm = lm_of(out)
    reports = lm if stops else 1
    cg_total = row["reads_eager"] - lm - reports
    bound = cg_total / pcg.BLOCK + lm + reports
    with graphs.mode("eager"):
        per_cg = ops_per_cg(lambda c: one_iteration(cg_iters=c))
    for line in lines:
        say("parallel", line)
    say("parallel", f"{label}: {cg_total} CG iterations; host reads graphed {row['reads_graph']} (limit one a CG "
        f"block of {pcg.BLOCK} and one an LM iteration: {bound:.1f}); {per_cg:.0f} operations a CG iteration eager")
    check(row["reads_graph"] <= bound, f"{label}: {row['reads_graph']} host reads, more than {bound:.1f}")
    return out, row


def phase_parallel(ctx, out_dir):
    """Phase 15: slice 6, the distributed solvers, on StackedMesh(8) on the
    card, each step also on a StackedMesh(8) on the CPU; each solve of
    (b)-(d) graphed against its eager mode, bit for bit and in turns
    (`parallel_solve`). (a) Halo exchange
    and SPIKE at test size against dense oracles; (b) the partitioned SE2
    solvers (jacobi, chain) and the distributed Schur solver on phase 12's
    world (21,662 DOF), the Schur one within 1.01x the float64 control;
    (c) the SE3 SPIKE solve on bench.py's 300-pose world within 1.01x its
    control; (d) the edge-sharded SE2, SE3 and BA solvers against the
    single-device ones; (e) ProcessMesh over NCCL at world size 1 against
    StackedMesh(1) for every solver of (b)-(d); (f) graph_optimizer
    --devices 8 on phase 12's file against (d)'s SE2 run."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from g2o_frontend_tpu_torch.apps import graph_optimizer
    from g2o_frontend_tpu_torch.parallel import halo, spike
    from g2o_frontend_tpu_torch.parallel.mesh import ProcessMesh, StackedMesh, make_mesh
    from g2o_frontend_tpu_torch.parallel.partitioned_pose_graph import (optimize_se2_partitioned,
                                                                        optimize_se3_partitioned)
    from g2o_frontend_tpu_torch.parallel.partitioned_schur import optimize_se2_schur_partitioned
    from g2o_frontend_tpu_torch.parallel.sharded_ba import optimize_ba_sharded
    from g2o_frontend_tpu_torch.parallel.sharded_pose_graph import optimize_se2_sharded
    from g2o_frontend_tpu_torch.parallel.sharded_pose_graph3d import optimize_se3_sharded
    from g2o_frontend_tpu_torch.solvers import ba as tba
    from g2o_frontend_tpu_torch.solvers import pose_graph as pg

    device, t15 = ctx["device"], time.perf_counter()
    cpu = torch.device("cpu")
    card, host = StackedMesh(MESH_D, device), StackedMesh(MESH_D, cpu)

    # (a) halo exchange and SPIKE at test size
    n_dev, B, G = MESH_D, 16, 7
    ghosts = random_ghosts(n_dev, B, G, seed=2)
    rng = np.random.default_rng(102)
    v, own, gh = rng.normal(size=(n_dev, B, 3)), rng.normal(size=(n_dev, B, 3)), rng.normal(size=(n_dev, G, 3))
    for s in range(n_dev):
        gh[s, len(ghosts[s]):] = 0.0
    flat, r_ref = v.astype(np.float32).reshape(-1, 3), own.astype(np.float32).astype(np.float64)
    for s in range(n_dev):
        for pos, gid in enumerate(ghosts[s]):
            r_ref[gid // B, gid % B] += np.float32(gh[s, pos])
    for mode in ("ppermute", "a2a"):
        spec = halo.build_halo_spec(ghosts, B, n_dev, G, mode=mode)
        res = {}
        for m in (card, host):
            sidx, rpos = m.local(spec.send_idx, torch.int64), m.local(spec.recv_pos, torch.int64)
            f32 = lambda a: m.local(a, torch.float32)  # noqa: E731
            res[m.device.type] = (halo.halo_gather(f32(v), sidx, rpos, spec, m).cpu().numpy(),
                                  halo.halo_reduce(f32(own), f32(gh), sidx, rpos, spec, m).cpu().numpy())
        g_card, r_card = res[device.type]
        exact = all(np.array_equal(g_card[s, pos], flat[gid]) for s in range(n_dev) for pos, gid in
                    enumerate(ghosts[s])) and all(not g_card[s, len(ghosts[s]):].any() for s in range(n_dev))
        err = float(np.abs(r_card - r_ref).max())
        say("parallel", f"(a) halo {mode} (D={n_dev}, B={B}, G={G}; {sum(map(len, ghosts))} ghosts, shifts "
            f"{list(spec.shifts)}, {halo.halo_bytes_per_exchange(spec, 3)} B and "
            f"{halo.halo_collectives_per_exchange(spec)} collectives an exchange): gather exact {exact}, equal to the "
            f"CPU {np.array_equal(g_card, res['cpu'][0])}; reduce against the oracle {err:.2e} (limit 1e-6)")
        check(exact and np.array_equal(g_card, res["cpu"][0]) and err <= 1e-6, f"halo {mode} disagrees")
    for d, m_rhs in ((3, 1), (6, 1), (3, 5)):
        (L, Dm, U, U_bnd, R), A = chain_shards(n_dev, d, 8, m_rhs, seed=10 * n_dev + d)
        X_ref = np.linalg.solve(A, R.astype(np.float64).reshape(-1, m_rhs)).reshape(R.shape)
        xs = {}
        for m in (card, host):
            sf = spike.spike_factor(*(m.local(a) for a in (L, Dm, U, U_bnd)), m)
            xs[m.device.type] = spike.spike_solve(sf, m.local(R[..., 0] if m_rhs == 1 else R), m).cpu().numpy()
        X = xs[device.type].reshape(R.shape)
        rel = float(np.abs(X - X_ref).max() / np.abs(X_ref).max())
        vs_cpu = float(np.abs(X - xs["cpu"].reshape(R.shape)).max())
        say("parallel", f"(a) spike_solve D={n_dev}, d={d}, {m_rhs} right-hand sides: against the dense float64 "
            f"solve {rel:.2e} of its largest entry (limit 2e-4), against the CPU {vs_cpu:.2e}")
        check(np.allclose(X, X_ref, rtol=2e-4, atol=2e-4), f"spike_solve (d={d}, m={m_rhs}) disagrees")

    # (b) the partitioned SE2 solvers on phase 12's world
    vic = ctx["victoria"]
    g, gc, ctl = vic["g"], vic["gc"], vic["ctl"]
    comm = None
    rows = ctx.setdefault("parallel_ms", {})
    for precond in ("jacobi", "chain"):
        caps = dict(precond=precond, **PART_CAPS)
        label = f"(b) optimize_se2_partitioned D={MESH_D} {caps}"
        (_, tr, st), rows[label] = parallel_solve(
            label, lambda: optimize_se2_partitioned(g, card, **caps),
            lambda **kw: optimize_se2_partitioned(g, card, **{**caps, "iters": 1, **kw}), lambda out: caps["iters"])
        comm = st["comm"]
        ref = pg.optimize_se2(g, precond=precond, **PART_CAPS)[1].chi2
        _, tr_cpu, _ = optimize_se2_partitioned(gc, host, **{**caps, "iters": CPU_LM})
        ok_cpu, rel_cpu = trace_close(tr[:CPU_LM + 1], tr_cpu, 1e-3)
        ok_one, rel_one = trace_close(tr, ref, 1e-3 if precond == "jacobi" else float("inf"))
        say("parallel", f"{label}: CG iterations {st['cg_total']}; chi2 {float(tr[-1]):.4f} "
            f"({float(tr[-1]) / ctl['chi2']:.4f}x the control, not gated); single-device optimize_se2 ({precond}) "
            f"{float(ref[-1]):.4f}, traces within {rel_one:.2e}"
            f"{' (limit 1e-3)' if precond == 'jacobi' else ' (a global chain: not gated)'}; first {CPU_LM} LM "
            f"iterations on the CPU within {rel_cpu:.2e} (limit 1e-3)")
        check(ok_cpu and (ok_one or precond == "chain"), f"partitioned {precond} traces disagree")
    say("parallel", f"(b) comm_volume: {comm['bytes_per_matvec']} B and {comm['collectives_per_matvec']} collectives a "
        f"matvec, {comm['bytes_per_lm_iter']} B an LM iteration; halo {comm['halo_mode']} shifts {comm['halo_shifts']}"
        f" ({comm['halo_slots']} slots), landmarks {comm['halo_lm_mode']} ({comm['halo_lm_slots']} slots)")
    label = f"(b) optimize_se2_schur_partitioned D={MESH_D} {SCHUR_PART_CAPS}"
    (_, tr, st), rows[label] = parallel_solve(
        label, lambda: optimize_se2_schur_partitioned(g, card, **SCHUR_PART_CAPS),
        lambda **kw: optimize_se2_schur_partitioned(g, card, **{**SCHUR_PART_CAPS, "iters": 1, **kw}),
        lambda out: out[2]["lm_iters"], stops=True)
    ratio = float(tr[-1]) / ctl["chi2"]
    _, tr_cpu, _ = optimize_se2_schur_partitioned(gc, host, **{**SCHUR_PART_CAPS, "iters": CPU_LM})
    ok, rel = trace_close(tr[:CPU_LM + 1], tr_cpu[:CPU_LM + 1], 1e-3)
    say("parallel", f"{label}: LM iterations {st['lm_iters']}, CG iterations {st['cg_total']}; chi2 "
        f"{float(tr[-1]):.6f}, {ratio:.6f}x the control (limit 1.01); first {CPU_LM} LM iterations on the CPU within "
        f"{rel:.2e} (limit 1e-3); {st['replicated_psum_floats_per_cg_iter']} replicated psum floats a CG iteration, "
        f"{st['replicated_psum_floats_per_lm_iter']} an LM iteration")
    check(ratio <= 1.01 and ok, f"distributed Schur reached {ratio:.6f}x the control, CPU within {rel:.2e}")

    # (c) SE3 SPIKE on bench.py's 300-pose world
    g3, ctl3 = ctx["se3"][300]
    g3c = g3.to("cpu")
    label = f"(c) optimize_se3_partitioned D={MESH_D} {SE3_SPIKE_CAPS}"
    (_, tr), rows[label] = parallel_solve(
        label, lambda: optimize_se3_partitioned(g3, card, **SE3_SPIKE_CAPS),
        lambda **kw: optimize_se3_partitioned(g3, card, **{**SE3_SPIKE_CAPS, "iters": 1, **kw}),
        lambda out: SE3_SPIKE_CAPS["iters"])
    ratio = float(tr[-1]) / ctl3["chi2"]
    _, tr_cpu = optimize_se3_partitioned(g3c, host, **{**SE3_SPIKE_CAPS, "iters": CPU_LM})
    ok, rel = trace_close(tr[:CPU_LM + 1], tr_cpu, 1e-3)
    say("parallel", f"{label}: chi2 {float(tr[-1]):.4f}, control {ctl3['chi2']:.4f}, {ratio:.6f}x (limit 1.01); "
        f"first {CPU_LM} LM iterations on the CPU within {rel:.2e} (limit 1e-3)")
    check(np.isfinite(ratio) and ratio <= 1.01 and ok, f"SE3 SPIKE reached {ratio:.6f}x its control")

    # (d) the edge-sharded solvers against the single-device ones
    poses7, points_init, obs = ctx["ba_big"]
    ba, ba_c = (tba.make_ba_problem(poses7, points_init, obs, device=dv) for dv in (device, cpu))
    g2k, _ = ctx["se3"][2000]
    g2k_c = g2k.to("cpu")
    sharded = {
        "se2": (optimize_se2_sharded, g, gc, SE2_SHARD_CAPS, lambda: pg.optimize_se2(g, **SE2_SHARD_CAPS)[1].chi2),
        "se3": (optimize_se3_sharded, g2k, g2k_c, SE3_SHARD_CAPS,
                lambda: pg.optimize_se3(g2k, **SE3_SHARD_CAPS)[1].chi2),
        "ba": (optimize_ba_sharded, ba, ba_c, BA_SHARD_CAPS, lambda: tba.optimize_ba(ba, **BA_SHARD_CAPS)[1]),
    }
    se2_sharded = None
    for name, (solve, prob, prob_c, caps, single) in sharded.items():
        label = f"(d) {solve.__name__} D={MESH_D} {caps}"
        (_, tr), rows[label] = parallel_solve(label, lambda: solve(prob, card, **caps),
                                              lambda **kw: solve(prob, card, **{**caps, "iters": 1, **kw}),
                                              lambda out: caps["iters"])
        ok_one, rel_one = trace_close(tr, single(), 1e-3)
        _, tr_cpu = solve(prob_c, host, **{**caps, "iters": CPU_LM})
        ok_cpu, rel_cpu = trace_close(tr[:CPU_LM + 1], tr_cpu, 1e-3)
        se2_sharded = tr if name == "se2" else se2_sharded
        say("parallel", f"{label}: chi2 {float(tr[0]):.4f} -> {float(tr[-1]):.4f}; the single-device solver's trace "
            f"within {rel_one:.2e}, the first {CPU_LM} LM iterations on the CPU within {rel_cpu:.2e} (limits 1e-3)")
        check(ok_one and ok_cpu and float(tr[-1]) < float(tr[0]), f"{solve.__name__} disagrees")

    # (e) ProcessMesh over NCCL at world size 1 against StackedMesh(1)
    runs = {
        "optimize_se2_partitioned (jacobi)": lambda m: optimize_se2_partitioned(g, m, **{**PART_CAPS,
                                                                                       "iters": NCCL_LM})[:2],
        "optimize_se2_partitioned (chain)": lambda m: optimize_se2_partitioned(
            g, m, precond="chain", **{**PART_CAPS, "iters": NCCL_LM})[:2],
        "optimize_se2_schur_partitioned": lambda m: optimize_se2_schur_partitioned(
            g, m, **{**SCHUR_PART_CAPS, "iters": NCCL_LM})[:2],
        "optimize_se3_partitioned (spike)": lambda m: optimize_se3_partitioned(g3, m, **{**SE3_SPIKE_CAPS,
                                                                                       "iters": NCCL_LM}),
        "optimize_se2_sharded": lambda m: optimize_se2_sharded(g, m, **{**SE2_SHARD_CAPS, "iters": NCCL_LM}),
        "optimize_se3_sharded": lambda m: optimize_se3_sharded(g2k, m, **{**SE3_SHARD_CAPS, "iters": NCCL_LM}),
        "optimize_ba_sharded": lambda m: optimize_ba_sharded(ba, m, **{**BA_SHARD_CAPS, "iters": NCCL_LM}),
    }
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            nccl = make_mesh(1, device)
            check(isinstance(nccl, ProcessMesh), "make_mesh under torch.distributed gave no ProcessMesh")
            for name, run_ in runs.items():
                (a, tr_a), nccl_s = host_s(lambda: run_(nccl))
                (b, tr_b), _ = host_s(lambda: run_(StackedMesh(1, device)))
                x_a, x_b = (getattr(x, "poses") for x in (a, b))
                same = bool(torch.allclose(tr_a, tr_b, rtol=1e-6, atol=0) and
                            torch.allclose(x_a, x_b, rtol=1e-6, atol=1e-6))
                say("parallel", f"(e) {name}, {NCCL_LM} LM iterations on ProcessMesh (NCCL, world size 1) in "
                    f"{nccl_s:.2f} s: trace {[round(float(t), 4) for t in tr_a]}, against StackedMesh(1) "
                    f"max |d chi2| {float((tr_a - tr_b).abs().max()):.3e}, max |d pose| "
                    f"{float((x_a - x_b).abs().max()):.3e} (limit rtol 1e-6)")
                check(same, f"{name} on NCCL differs from StackedMesh(1)")
        finally:
            dist.destroy_process_group()

    # (f) the command line
    out, app_s = host_s(lambda: graph_optimizer.run(
        [vic["path"], "-o", os.path.join(out_dir, "victoria_d8.g2o"), "--devices", str(MESH_D), "--iters",
         str(SE2_SHARD_CAPS["iters"]), "--cg-iters", str(SE2_SHARD_CAPS["cg_iters"])]))
    say("parallel", f"(f) graph_optimizer --devices {MESH_D} on the file: {app_s:.2f} s, chi2 "
        f"{out['chi2_initial']:.6g} -> {out['chi2_final']:.6f}; (d)'s optimize_se2_sharded {float(se2_sharded[-1]):.6f} "
        "(limit: equal, the same code on the same card)")
    check(out["chi2_final"] == float(se2_sharded[-1]) and abs(out["chi2_initial"] / float(se2_sharded[0]) - 1) <= 1e-5,
          "graph_optimizer --devices disagrees with optimize_se2_sharded")
    say("parallel", "graphed against eager, whole solves: " + "; ".join(
        f"{k} {r['graph_ms']:.3f} / {r['eager_ms']:.3f} ms ({r['eager_ms'] / r['graph_ms']:.2f}x), "
        f"reads {r['reads_graph']} / {r['reads_eager']}, the chain's capture call {r['capture_ms']:.1f} ms, pool "
        f"+{r['pool_bytes']} B" for k, r in rows.items()))
    say("parallel", f"phase 15 took {time.perf_counter() - t15:.1f} s")


# The JAX package's stress run (scripts/evaluate.py::eval_pwn_slam_long,
# fast=False) on a CPU under JAX_PLATFORMS=cpu: 500 frames, 53 keyframes, 9
# retired, 83 closures of 244 candidates, 218 evictions, no fallback, online
# ATE 0.3029 m, optimised-keyframe ATE 0.3122 m (PERF.md section 6)
JAX_STRESS = dict(keyframes=53, closures_committed=83, cache_evictions=218, fallbacks=0, ate_rmse_m=0.30293319746651975,
                  kf_ate_rmse_m=0.31222691525050744)
# the whole flagship step on the card against the CPU: the converters'
# integral images differ (torch.cumsum accumulates float32 in float32 on the
# card, in float64 on the CPU), and the pair's surface, constant down each
# column, barely constrains one axis; a CPU rehearsal with a float32 scan
# moved T by 2.4e-4 m and 3.9e-4 rad, inliers 0.7%, omega 1.5%
ENTRY_STEP_TOL = dict(t_m=1e-3, r_rad=1e-3, inliers=0.02, omega_rtol=5e-2)
# the card's align against the CPU's on the card's own clouds
ENTRY_ALIGN_TOL = dict(t_m=1e-4, r_rad=1e-4, inliers=0.005, omega_rtol=1e-3)


def rot_err(A, B):
    """Angle (rad) between the rotations of two 4x4 poses, from the skew
    part of A^T B (arccos of the trace loses ~3e-4 rad to float32)."""
    import numpy as np

    d = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    return float(np.linalg.norm([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]]) / 2)


def entry_close(name, card, cpu, tol):
    """Check (T, omega, inliers) of the card against the CPU's within `tol`."""
    (T, omega, inl), (Tc, omegac, inlc) = ([x.cpu().double().numpy() for x in r] for r in (card, cpu))
    dt, dr = float(abs(T[:3, 3] - Tc[:3, 3]).max()), rot_err(T, Tc)
    di = abs(float(inl) - float(inlc)) / float(inlc)
    do = float(abs(omega - omegac).max() / abs(omegac).max())
    say("entry", f"(a) {name}: T {dt:.3e} m, {dr:.3e} rad; inliers {int(inl)} vs {int(inlc)} ({di:.2e}); omega "
        f"{do:.2e} of its largest entry (limits {tol['t_m']} m, {tol['r_rad']} rad, {tol['inliers']}, {tol['omega_rtol']})")
    check(dt <= tol["t_m"] and dr <= tol["r_rad"] and di <= tol["inliers"] and do <= tol["omega_rtol"],
          f"{name}: the card and the CPU differ beyond the limits")


def phase_entry_points(ctx, out_dir):
    """Phase 16: the system's own entry points. (a) entry() on the card
    against the CPU (the whole step, and the align on the card's clouds),
    dryrun_multichip(8); (b) the bench's JSON line and a CPU run of the
    aligner bench for vs_baseline; (c) the four dataset-free EVAL sections
    at full size, the stress run without and with the cloud cache. Returns
    the (kernel-1, kernel-2) launches of each path: entry(), the bench and
    the no-cache stress run."""
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch import entry
    from g2o_frontend_tpu_torch.apps import bench, evaluate
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn import aligner as al
    from g2o_frontend_tpu_torch.pwn import converter as cv
    from g2o_frontend_tpu_torch.pwn.aligner import align
    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud

    t16 = time.perf_counter()
    # (a) the flagship step
    fn, args = entry.entry()
    fa.launches = 0
    card, ms = timed(lambda: fn(*args))
    launches = fa.launches
    proj, ccfg, acfg = entry.flagship_configs()
    per_align = acfg.outer_iterations * acfg.inner_iterations + 1
    say("entry", f"(a) entry() on the card: {ms:.3f} ms (CUDA events, the first call); T translation "
        f"{card[0][:3, 3].cpu().numpy().round(6).tolist()}, inliers {int(card[2])}; kernel-1 launches {launches}")
    check(launches == per_align, f"entry() launched kernel 1 {launches} times, not {per_align}")
    again = fn(*args)
    clouds = [depth_to_cloud(ctx["d_ref"], ctx["proj"], ctx["ccfg"]) for _ in range(2)]
    same_step = same_bits(*zip(card, again))
    same_cloud = same_bits(*zip(*clouds))
    say("entry", f"(a) entry() a second time on the card: T, omega and inliers bit-equal {same_step}; depth_to_cloud "
        f"twice on the 640x480 bench image: every channel bit-equal {same_cloud}")
    check(same_step and same_cloud, "two card runs of entry() or depth_to_cloud differ")
    eager = al._align(*(cv._depth_to_cloud(d, proj, ccfg, None) for d in args), proj, None, acfg, None)
    same_eager = same_bits(*zip(card, (eager.T, eager.omega, eager.inliers)))
    say("graphs", f"(a) entry()'s T, omega and inliers bit-equal to its stages' eager bodies: {same_eager}")
    check(same_eager, "entry()'s graphs differ from the eager bodies")
    entry_close("the whole step against the CPU", card, fn(*(a.cpu() for a in args)), ENTRY_STEP_TOL)
    ref, cur = (depth_to_cloud(d, proj, ccfg) for d in args)
    res = align(ref, cur, proj, config=acfg)
    res_cpu = align(cpu_copy(ref), cpu_copy(cur), proj, config=acfg)
    entry_close("align on the card's clouds against the CPU", (res.T, res.omega, res.inliers),
                (res_cpu.T, res_cpu.omega, res_cpu.inliers), ENTRY_ALIGN_TOL)
    dry, dry_s = host_s(lambda: entry.dryrun_multichip(MESH_D))
    say("entry", f"(a) dryrun_multichip({MESH_D}) on the card: {dry_s:.2f} s; distributed Schur "
        f"{dry['schur_stats']['lm_iters']} LM / {dry['schur_stats']['cg_total']} CG, SE3 SPIKE "
        f"{float(dry['se3_spike'][-1]):.4f} against the control {dry['se3_control']:.4f}")

    # (b) the bench, then the CPU's aligner rate for vs_baseline
    fa.launches, fa.batch_launches = 0, 0
    out, bench_s = host_s(lambda: bench.run(["--no-cpu-control"]))
    bench_launches = (fa.launches, fa.batch_launches)
    print(json.dumps(out), flush=True)
    (cpu_bench, cpu_s) = host_s(lambda: bench.bench_pwn_aligner("cpu", reps=1))
    say("bench", f"(b) {bench_s:.1f} s; kernel-1 launches {bench_launches[0]}, kernel-2 {bench_launches[1]}; SE3 "
        f"world at D = 8 {out['se3_sim_chi2_distributed_8dev'] / out['se3_sim_chi2_control']:.6f}x the control; "
        f"the CPU's aligner {cpu_bench['align_fps']:.4f} frames/s, convert {cpu_bench['convert_fps']:.4f} frames/s "
        f"({cpu_s:.1f} s, {torch.get_num_threads()} threads): vs_baseline {out['value'] / cpu_bench['align_fps']:.3f}")
    check(bench_launches[0] > 0, "the bench did not launch kernel 1")
    ctx["bench"] = {k: out[k] for k in ("value", "convert_fps", "tracker_fps_e2e", "align_fps_scale4")}
    ctx["captures"] = report_captures("bench", ctx.get("captures", 0))

    # (c) the evaluation protocols at full size
    def section(name, fn_):
        t0 = time.perf_counter()
        r = fn_()
        wall = time.perf_counter() - t0
        print(json.dumps({"section": name, **r, "section_wall_s": wall}), flush=True)
        return r

    g = section("grid_slam_gt", lambda: evaluate.grid_slam_gt(False))
    say("eval", f"(c) grid_slam_gt, {g['frames']} scans: ATE {g['ate_slam_m']:.4f} m against the odometry's "
        f"{g['ate_odom_m']:.4f} m ({g['ate_slam_m'] / g['ate_odom_m']:.3f}x, limit 0.75x)")
    check(g["frames"] == 120 and g["ate_slam_m"] < 0.75 * g["ate_odom_m"], "grid_slam_gt missed its gate")
    o = section("pwn_odometry_tum", lambda: evaluate.pwn_odometry_tum(False, out_dir))
    with open(o["benchmark_file"]) as fh:
        cols = {len(ln.split()) for ln in fh if ln.strip()}
    say("eval", f"(c) pwn_odometry_tum, scale 2: ATE {o['ate']['rmse']:.4f} m (limit 0.5 m); {o['benchmark_rows']} "
        f"benchmark rows of {sorted(cols)} columns")
    check(cols == {14} and o["benchmark_rows"] == o["frames"] and o["ate"]["rmse"] < 0.5, "pwn_odometry_tum missed")
    sl = section("pwn_slam", lambda: evaluate.pwn_slam(out_dir))
    check(np.isfinite(sl["final_chi2"]), "pwn_slam's chi2 is not finite")
    stress = {}
    for cache in (False, True):
        fa.launches, fa.batch_launches = 0, 0
        stress[cache] = section(f"pwn_slam_long{'' if cache else ' (no cloud cache)'}",
                                lambda: evaluate.pwn_slam_long(n_frames=500, cloud_cache=cache))
        stress[cache]["launches"] = (fa.launches, fa.batch_launches)
        say("eval", f"(c) stress run, cloud cache {cache}: {stress[cache]['frames'] / stress[cache]['wall_s']:.2f} "
            f"frames/s; kernel-1 launches {fa.launches}, kernel-2 launches {fa.batch_launches}")
        ctx.setdefault("stress_fps", []).append(stress[cache]["frames"] / stress[cache]["wall_s"])
    ctx["captures"] = report_captures("eval", ctx.get("captures", 0))
    r, j = stress[False], JAX_STRESS
    say("eval", f"(c) the no-cache stress run against the JAX CPU run: keyframes {r['keyframes']} vs {j['keyframes']} "
        f"(limit +-15%), closures {r['closures_committed']} vs {j['closures_committed']} (limit >= 0.8x), fallbacks "
        f"{r['fallbacks']}, evictions {r['cache_evictions']} vs {j['cache_evictions']}, keyframe ATE "
        f"{r['kf_ate_rmse_m']:.4f} vs {j['kf_ate_rmse_m']:.4f} m (limit 1.25x and 0.5 m), online ATE "
        f"{r['ate_rmse_m']:.4f} vs {j['ate_rmse_m']:.4f} m")
    check(abs(r["keyframes"] - j["keyframes"]) <= 0.15 * j["keyframes"]
          and r["closures_committed"] >= 0.8 * j["closures_committed"] and r["fallbacks"] == 0
          and r["cache_evictions"] > 0 and r["kf_ate_rmse_m"] <= min(1.25 * j["kf_ate_rmse_m"], 0.5),
          "the stress run missed its gates against the JAX run")
    check(r["launches"][0] > 0 and r["launches"][1] > 0, "the stress run did not launch kernels 1 and 2")
    say("entry", f"phase 16 took {time.perf_counter() - t16:.1f} s")
    return {"entry": (launches, 0), "bench": bench_launches, "stress_run": r["launches"]}


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
    t_start = time.perf_counter()
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    device = torch.device("cuda:0")

    # 2. build
    build_kernels()

    d_ref, d_cur, proj, T_gt = bench_pair(device)
    ccfg, acfg = ConverterConfig(), AlignerConfig()
    ref, cur = depth_to_cloud(d_ref, proj, ccfg), depth_to_cloud(d_cur, proj, ccfg)
    ctx = dict(device=device, proj=proj, ccfg=ccfg, acfg=acfg, ref=ref, cur=cur, d_ref=d_ref, d_cur=d_cur, T_gt=T_gt,
               inv_gt=np.linalg.inv(T_gt), cur_packed=fa.pack_cur(cur), ref_table=fa.pack_ref(ref),
               per_align=acfg.outer_iterations * acfg.inner_iterations + 1,
               steps_per_align=acfg.outer_iterations * acfg.inner_iterations)

    def phase(n, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say("time", f"phase {n} took {time.perf_counter() - t0:.1f} s")
        return out

    say("time", f"phases 1-2 took {time.perf_counter() - t_start:.1f} s")
    err1 = phase(3, phase_kernel1, ctx)
    k1_ms, k1_plain_ms, k1_bound, (err_step, step_ms, step_plain_ms, step_bound) = phase(4, phase_align, ctx)
    k1_launches, step_launches = phase(5, phase_tracker, ctx, out_dir)
    ctx["refs"], ctx["ref_list"], ctx["T_true"], ctx["poses"] = candidates(ctx)
    phase(6, phase_kernel2, ctx)
    phase(7, phase_align_batch, ctx)
    err3, k3_ms, k3_plain_ms, k3_launches, k3_bound = phase(8, phase_kernel3, ctx)
    with SolverCalls("slam") as calls:
        k2_launches, err2, k2_ms, k2_previous_ms, k2_plain_ms, k2_bound = phase(9, phase_slam, ctx, out_dir)
    callers = {9: calls.report()}
    gather_entries = phase(10, phase_gather, ctx)
    t11 = time.perf_counter()  # 11
    phase_conf_apps(ctx, out_dir)
    phase_fusion(ctx)
    phase_planes(ctx)
    phase_manifold(ctx)
    phase_cloud_io(ctx, out_dir)
    say("pwn", f"phase 11 took {time.perf_counter() - t11:.1f} s")
    try:
        phase(12, phase_backend, ctx, out_dir)
        with SolverCalls("slam2d") as calls:
            phase(13, phase_slam2d, ctx, out_dir)
        callers[13] = calls.report()
        with SolverCalls("slice5") as calls:
            phase(14, phase_slice5, ctx, out_dir)
        callers[14] = calls.report()
    finally:  # the CPU worker of phases 12 and 14
        if "cpu_pool" in ctx:
            ctx.pop("cpu_pool").terminate()
    phase(15, phase_parallel, ctx, out_dir)
    with SolverCalls("entry") as calls:
        paths16 = phase(16, phase_entry_points, ctx, out_dir)
    callers[16] = calls.report()
    say("graphs", "graph against eager, whole calls at 640x480 (ms): " + "; ".join(
        f"{r['stage']} {r['graph_ms']:.4f} vs {r['eager_ms']:.4f} ({r['speedup']:.2f}x, device idle "
        f"{100 * r['graph_idle_share']:.1f}% of a replay)" for r in ctx["stage_ms"]))
    say("graphs", f"bench {json.dumps(ctx['bench'])}; tracker frames/s {json.dumps(ctx['tracker_fps'])}; stress run "
        f"frames/s (no cache, cache) {ctx['stress_fps']}; {ctx['captures']} keys captured")
    say("graphs", f"tracker2d frames/s (graph, eager) {json.dumps(ctx['tracker2d_fps'])}; line SLAM scans/s "
        f"{json.dumps(ctx['line_scans_s'])}; grid SLAM scans/s {json.dumps(ctx['grid_scans_s'])}")
    say("graphs", "distributed solves on StackedMesh(8), graph against eager (ms): " + "; ".join(
        f"{k[4:]} {v['graph_ms']:.3f} vs {v['eager_ms']:.3f} ({v['eager_ms'] / v['graph_ms']:.2f}x)"
        for k, v in ctx["parallel_ms"].items()))
    say("graphs", "solves at victoriaPark's counts and the landmark solves, graph against eager (ms): " + "; ".join(
        f"{k} {v['graph_ms']:.3f} vs {v['eager_ms']:.3f} ({v['eager_ms'] / v['graph_ms']:.2f}x)"
        for k, v in ctx["solve_ms"].items()) + "; the callers' solves, graphed against their eager reruns (ms): "
        + "; ".join(f"phase {n} {c['graphed_ms']:.1f} vs {c['eager_ms']:.1f} over {c['rerun']} of {c['calls']} calls"
                    for n, c in callers.items()))

    kernels = []
    for name, source, replaces, launches, err, ms, plain_ms, (bound_ms, bound_by) in (
        ("fused_aligner", "fused_aligner.cu", "ops/pallas_aligner.py:627", k1_launches, err1, k1_ms, k1_plain_ms,
         k1_bound),
        ("fused_aligner_batch", "fused_aligner.cu", "ops/pallas_aligner.py:730", k2_launches, err2, k2_ms,
         k2_plain_ms, k2_bound),
        ("linearizer", "linearizer.cu", "ops/pallas_linearizer.py:164", k3_launches, err3, k3_ms, k3_plain_ms,
         k3_bound),
        ("gauss_newton_step", "fused_aligner.cu", "pwn/aligner.py:530 (gn_step and the chart, XLA; no pl.pallas_call)",
         step_launches, err_step, step_ms, step_plain_ms, step_bound),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"g2o_frontend_tpu_torch/csrc/{source}",
            "replaces": f"g2o_frontend_tpu/{replaces}", "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    kernels[1]["previous_ms"] = k2_previous_ms  # the previous batch design, in the same turns
    for k, row in enumerate(kernels[:2]):  # phase 16's paths, each counted from 0
        row["launches_phase16"] = {path: counts[k] for path, counts in paths16.items() if counts[k]}
    kernels += gather_entries
    sums, paths = ctx["segment_sum"], ctx["segment_sum_launches"]
    top = sums["top"]
    kernels.append({
        "name": "segment_sum", "route": "cuda", "source": "g2o_frontend_tpu_torch/csrc/segment_sum.cu",
        "replaces": "jax.ops.segment_sum (XLA, no pl.pallas_call)", "launches": paths["line_slam"],
        "max_abs_err": sums["err"], "ms": top["ms"], "previous_ms": top["previous_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": top["library_ms"], "launches_paths": paths,
        "call": {k: top[k] for k in ("path", "launches", "rows", "columns", "segments", "longest")},
        "calls": [{k: r[k] for k in ("path", "launches", "rows", "columns", "segments", "longest", "long_segments",
                                     "ms", "previous_ms", "library_ms", "bound_ms")} for r in sums["calls"]],
    })
    check(all(n > 0 for n in paths.values()), f"a solver path did not launch the segment-sum kernel: {paths}")
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
