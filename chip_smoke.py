#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's main path: PWN dense RGB-D odometry.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a), the
CUDA toolkit and PyTorch built for CUDA; JAX is not needed:

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero:
  1. device: the card, its power limit, torch and CUDA versions;
  2. build: nvcc builds csrc/fused_aligner.cu from the checkout;
  3. kernel against its plain PyTorch version on the 640x480 bench pair at
     three poses (identity, ground truth, a 5 cm / 3 deg perturbation), and
     once more with the non-robust chi2 gate;
  4. align at 640x480 with the default configs: t_err gate, launch count,
     median convert/align times by CUDA events, and device times (profiler)
     of the kernel, its plain version, align and convert;
  5. the tracker command line over the bundled 120-frame TUM sequence at
     scale 2 (ATE gate, per-frame and --scan modes) and, as the main-path
     run whose kernel launches are counted, at scale 1 (640x480).
Then one JSON line of the kernels, and a last JSON line with the device.
"""
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


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def bench_pair(device):
    import numpy as np
    import torch

    from g2o_frontend_tpu_torch.pwn.projector import PinholeProjector
    from g2o_frontend_tpu_torch.utils import lie
    from g2o_frontend_tpu_torch.utils.synth import render_planes_depth

    H, W = 480, 640
    proj = PinholeProjector(rows=H, cols=W, fx=525.0, fy=525.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5,
                            min_distance=0.1, max_distance=10.0)
    planes = [(np.array(n), d) for n, d in BENCH_PLANES]
    T_gt = lie.se3_exp(torch.tensor(BENCH_XI, dtype=torch.float32)).numpy()
    d_ref = render_planes_depth(np.eye(4), proj, planes, device=device)
    d_cur = render_planes_depth(T_gt, proj, planes, device=device)
    return d_ref, d_cur, proj, T_gt


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


def run(out_dir):
    import numpy as np
    import torch

    import g2o_frontend_tpu_torch  # noqa: F401  (turns TF32 off)
    from g2o_frontend_tpu_torch.apps import pwn_odometry
    from g2o_frontend_tpu_torch.ops import fused_aligner as fa
    from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig, align
    from g2o_frontend_tpu_torch.pwn.converter import ConverterConfig, depth_to_cloud
    from g2o_frontend_tpu_torch.utils import lie

    check("jax" not in sys.modules, "the port imported jax")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; CUDA {torch.version.cuda}")
    device = torch.device("cuda:0")

    # 2. build
    lib, secs, log = fa.build()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"{os.path.relpath(lib, REPO)} built in {secs:.1f} s; " + " | ".join(ptxas))

    # 3. kernel against its plain version at the main path's shapes
    d_ref, d_cur, proj, T_gt = bench_pair(device)
    ccfg, acfg = ConverterConfig(), AlignerConfig()
    ref = depth_to_cloud(d_ref, proj, ccfg)
    cur = depth_to_cloud(d_cur, proj, ccfg)
    cur_packed, ref_table = fa.pack_cur(cur), fa.pack_ref(ref)
    inv_gt = np.linalg.inv(T_gt)
    perturb = lie.se3_exp(torch.tensor([0.05, 0.0, 0.0, 0.0, np.deg2rad(3.0), 0.0])).numpy()
    max_abs_err = 0.0
    non_robust = dataclasses.replace(acfg, robust_kernel=False, inlier_max_chi2=2.0)
    for name, invT, cfg in (
        ("identity", np.eye(4), acfg),
        ("ground truth", inv_gt, acfg),
        ("5cm/3deg", perturb @ inv_gt, acfg),
        ("5cm/3deg, non-robust chi2 gate", perturb @ inv_gt, non_robust),
    ):
        params = fa.params_from_invT(torch.as_tensor(invT, dtype=torch.float32, device=device))
        sk = fa.fused_system(cur_packed, ref_table, params, proj, cfg)
        sp = fa.fused_system_reference(cur_packed, ref_table, params, proj, cfg)
        torch.cuda.synchronize()
        Hk, bk, ck, ik = (x.double().cpu() for x in fa.unpack_sums(sk))
        Hp, bp, cp, ip = (x.double().cpu() for x in fa.unpack_sums(sp))
        max_abs_err = max(max_abs_err, float((sk - sp).abs().max()))
        dH = float((Hk - Hp).norm() / Hp.norm())
        db = float((bk - bp).norm() / bp.norm())
        dc = float(abs(ck - cp) / abs(cp))
        say("kernel", f"{name}: inliers {int(ik)} vs plain {int(ip)}; rel err H {dH:.2e} b {db:.2e} chi2 {dc:.2e}")
        check(abs(int(ik) - int(ip)) <= max(4, 1e-4 * int(ip)), f"{name}: inliers differ")
        check(dH <= 1e-3 and db <= 1e-3 and dc <= 1e-3, f"{name}: sums differ beyond rtol 1e-3")
        check(int(ip) > 0, f"{name}: no inliers")

    # 4. align at 640x480, default configs
    before = fa.launches
    res = align(ref, cur, proj, config=acfg)
    torch.cuda.synchronize()
    grew = fa.launches - before
    T_est = res.T.double().cpu().numpy()
    t_err = float(np.linalg.norm((np.linalg.inv(T_gt) @ T_est)[:3, 3]))
    say("align", f"t_err {t_err:.3e} m; inliers {int(res.inliers)} (JAX bench record {BENCH_INLIERS}); "
        f"valid {bool(res.valid)}; kernel launches +{grew}")
    per_align = acfg.outer_iterations * acfg.inner_iterations + 1
    check(grew == per_align, f"launches grew by {grew}, not {per_align}")
    check(t_err < 0.01, f"t_err {t_err} >= 0.01 m")
    check(all(bool(torch.isfinite(x).all()) for x in (res.T, res.omega, res.mean)), "non-finite align result")
    for association in ("fused", "gather"):  # one kernel path for all three names
        before = fa.launches
        other = align(ref, cur, proj, config=dataclasses.replace(acfg, association=association))
        check(fa.launches - before == per_align and torch.equal(other.T, res.T),
              f"association={association!r} did not run the same kernel path")
    say("align", f"association 'fused' and 'gather' launch the kernel {per_align} times and give the same T")
    conv_ms = float(np.median(event_ms(lambda: depth_to_cloud(d_cur, proj, ccfg), 30)))
    align_ms = float(np.median(event_ms(lambda: align(ref, cur, proj, config=acfg), 30)))
    params = fa.params_from_invT(torch.as_tensor(inv_gt, dtype=torch.float32, device=device))

    def kernel():
        return fa.fused_system(cur_packed, ref_table, params, proj, acfg)

    def plain():
        return fa.fused_system_reference(cur_packed, ref_table, params, proj, acfg)

    say("timing", f"CUDA events, median over 30 runs: depth_to_cloud {conv_ms:.3f} ms, align {align_ms:.3f} ms; "
        f"one system at 640x480, back-to-back calls: kernel {batch_ms(kernel, 200):.4f} ms, "
        f"plain {batch_ms(plain, 30):.4f} ms")
    kernel_ms, plain_ms = device_ms(kernel, 50), device_ms(plain, 20)
    say("timing", f"device time per call (torch.profiler): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"align {device_ms(lambda: align(ref, cur, proj, config=acfg), 10):.4f} ms, "
        f"depth_to_cloud {device_ms(lambda: depth_to_cloud(d_cur, proj, ccfg), 10):.4f} ms")

    # 5. tracker over the bundled TUM sequence
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

    fa.launches = 0  # main-path run: count the kernel launches of this run only
    s1 = pwn_odometry.run([SEQ, "--device", "cuda", "--scale", "1", "--kf-fraction", "0.75",
                           "--out", os.path.join(out_dir, "traj_s1.txt")])
    main_launches = fa.launches
    ate1 = s1["ate"]["rmse"]
    say("tracker", f"scale 1 (640x480): ATE {ate1:.4f} m; keyframes {s1['keyframes']}/{s1['frames']}; "
        f"{s1['frames_per_s']:.2f} frames/s; kernel launches {main_launches}")
    check(s1["frames"] == 120 and np.isfinite(ate1), "scale-1 run incomplete")
    check(main_launches == per_align * (s1["frames"] - 1), f"main path launched the kernel {main_launches} times")

    print(json.dumps({"kernels": [{
        "name": "fused_aligner",
        "route": "cuda",
        "source": "g2o_frontend_tpu_torch/csrc/fused_aligner.cu",
        "replaces": "g2o_frontend_tpu/ops/pallas_aligner.py:233",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
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
