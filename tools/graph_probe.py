"""The captured stages (``g2o_frontend_tpu_torch/utils/graphs.py``) on the
card: each graph held bit for bit against its eager body, and the graphs
timed against the eager bodies.

1. Checks (`check_stages`, `check_fresh_outputs`, `check_other_guess`,
   `check_inline`, `check_capture_failure`; the card-only tests of
   ``tests/test_torch_graphs.py`` call them): on the bench pair
   (``utils/synth.bench_pair``) `depth_to_cloud`, `align` with each
   association and with a prior, `align_batch` over K candidates and
   `odometry_scan` over a few frames, each bit-equal to its private eager
   body on the same inputs, its launches counted as the eager body's; two
   calls return tensors that do not alias, and the first call's outputs
   survive the second; a second call with another initial guess gives the
   eager result for that guess; a call inside an enclosing capture runs
   inline; a capture that fails raises `CaptureError`.
2. Timing at 640x480 (`timing`): graph against eager in turns (eager,
   graph, graph, eager), CUDA events around whole calls, median of n
   calls: `depth_to_cloud`, `align`, `align_batch` at K = 8 and 21; the
   device time of each call by torch.profiler and the device's idle share
   of a call. Then every captured key with its capture ms, the bytes it
   added to the shared pool and its static inputs.

3. The solvers (`--solvers` runs them alone): `check_solvers` on a small
   world and at victoriaPark's counts (Schur with and without the
   Woodbury arrow, `optimize_se2` jacobi and chain, `optimize_se3` jacobi
   and chain, `optimize_se2_direct`, `landmark_covariance_se2`) and on
   small padded landmark graphs (`landmark_cases`: line SLAM's graph, the
   plane graph, BA), and `check_landmark_stages` (tracker2d's and line
   SLAM's per-frame stages against their eager bodies): three
   graphed calls of each (the key seen once, its capture, a replay)
   bit-equal to its "eager" mode, launches under replay equal to its
   masked steps run eagerly, host reads of both;
   `check_solver_capture_failure`; `block_sweep`, `pcg.BLOCK` over 1, 4,
   8, 16 and 32 on the Schur and the pose-only chain solve; then each
   solver graphed against eager in turns (`solve_turns`).

4. Grid SLAM's stages (`--grid` runs them alone): `check_grid_stages`
   (`build_likelihood_map`, `correlative_match`, `correlative_match_multires`
   at the match and the loop-closure radius, `gradient_refine`, each over
   three calls against its eager body), then each graph against eager in
   turns at grid SLAM's 800 x 800 map (`grid_timing`).
5. The distributed solvers (`--parallel` runs them alone): `check_solvers`
   on `parallel_cases` (the six solvers and their preconditioners on
   `StackedMesh(8)`), each graphed against eager in turns, then
   `nccl_capture`: the same solvers on a `ProcessMesh` over NCCL at world
   size 1, three calls each against the eager mode.

One JSON line per measurement. Run from the repository root on a machine
with a CUDA card (the kernels are built from the checkout):

    python3 tools/graph_probe.py [--no-timing] [--solvers | --grid | --parallel]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import g2o_frontend_tpu_torch  # noqa: E402,F401  (turns TF32 off)
from g2o_frontend_tpu_torch.ops import fused_aligner as fa  # noqa: E402
from g2o_frontend_tpu_torch.ops import linearizer as lin  # noqa: E402
from g2o_frontend_tpu_torch.pwn import aligner as al  # noqa: E402
from g2o_frontend_tpu_torch.pwn import converter as cv  # noqa: E402
from g2o_frontend_tpu_torch.slam import pwn_tracker as pt  # noqa: E402
from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds  # noqa: E402
from g2o_frontend_tpu_torch.utils import graphs, lie, synth  # noqa: E402
from g2o_frontend_tpu_torch.utils.profiling import CheckFailure, gpu_name_and_power_limit  # noqa: E402


def leaves(x):
    """The tensors of a tree of tuples, NamedTuples, lists and dicts."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def same_bits(a, b):
    """Two trees of tensors equal bit for bit (shapes, dtypes and bytes)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and x.cpu().contiguous().numpy().tobytes()
        == y.cpu().contiguous().numpy().tobytes() for x, y in zip(la, lb))


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def counts():
    return fa.launches, fa.batch_launches, lin.launches


def grew(fn):
    """(fn(), the launches of kernels 1, 2 and 3 it made)."""
    c0 = counts()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, tuple(b - a for a, b in zip(c0, counts()))


def inputs(device, H=480, W=640, K=8):
    """The bench pair's depths, projector, configs and ground truth, and K
    candidate references rendered around the identity with their guesses."""
    d_ref, d_cur, proj, T_gt = synth.bench_pair(device, H, W)
    ccfg = cv.ConverterConfig() if H >= 240 else cv.ConverterConfig(min_image_radius=3, max_image_radius=8,
                                                                     min_points=12)
    poses = synth.candidate_poses(K)
    refs = stack_clouds([cv.depth_to_cloud(synth.bench_depth(P, device, H, W), proj, ccfg) for P in poses])
    guesses = torch.as_tensor(np.linalg.inv(poses), dtype=torch.float32, device=device)
    return dict(d_ref=d_ref, d_cur=d_cur, proj=proj, T_gt=T_gt, ccfg=ccfg, acfg=al.AlignerConfig(), refs=refs,
                guesses=guesses, ref=cv.depth_to_cloud(d_ref, proj, ccfg), cur=cv.depth_to_cloud(d_cur, proj, ccfg))


def check_stages(x, scan_frames=4, zbuffer_k=2, errors=None):
    """Every stage on `x` (from `inputs`): the graph's outputs (second call
    of its key) bit-equal to the eager body's, and its launches equal.
    Returns {stage: (launches of kernels 1, 2, 3 a call)}. With a list
    `errors`, a case that raises is recorded there and the others go on."""
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    guess = torch.as_tensor(np.linalg.inv(x["T_gt"]), dtype=torch.float32, device=x["d_ref"].device)
    prior = al.absolute_prior(torch.eye(4, device=guess.device), guess, 10.0 * torch.eye(6, device=guess.device))
    zcfg = al.AlignerConfig(association="zbuffer")
    cases = {
        "depth_to_cloud": (lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg),
                           lambda: cv._depth_to_cloud(x["d_cur"], proj, ccfg, None)),
        "align": (lambda: al.align(x["ref"], x["cur"], proj, config=acfg),
                  lambda: al._align(x["ref"], x["cur"], proj, None, acfg, None)),
        "align, guess": (lambda: al.align(x["ref"], x["cur"], proj, guess.cpu().numpy(), acfg),
                         lambda: al._align(x["ref"], x["cur"], proj, guess, acfg, None)),
        "align, gather": (lambda: al.align(x["ref"], x["cur"], proj, config=al.AlignerConfig(association="gather")),
                          lambda: al._align(x["ref"], x["cur"], proj, None, al.AlignerConfig(association="gather"),
                                            None)),
        "align, zbuffer": (lambda: al.align(x["ref"], x["cur"], proj, config=zcfg),
                           lambda: al._align(x["ref"], x["cur"], proj, None, zcfg, None)),
        "align, prior": (lambda: al.align(x["ref"], x["cur"], proj, guess, acfg, prior),
                         lambda: al._align(x["ref"], x["cur"], proj, guess, acfg, prior)),
        "align_batch": (lambda: al.align_batch(x["refs"], x["cur"], proj, x["guesses"], acfg),
                        lambda: al._align_batch(x["refs"], x["cur"], proj, x["guesses"], acfg)),
        "align_batch, zbuffer": (
            lambda: al.align_batch(sub(x["refs"], zbuffer_k), x["cur"], proj, x["guesses"][:zbuffer_k], zcfg),
            lambda: al._align_batch(sub(x["refs"], zbuffer_k), x["cur"], proj, x["guesses"][:zbuffer_k], zcfg)),
    }
    depths = torch.stack([x["d_ref"] * (1.0 + 0.002 * k) for k in range(scan_frames)])
    cases["odometry_scan"] = (lambda: pt.odometry_scan(depths, proj, ccfg, acfg, device=depths.device),
                              lambda: eager_scan(depths, proj, ccfg, acfg))
    out = {}
    for name, (graphed, eager) in cases.items():
        try:
            graphed()  # captures the key
            g, n_g = grew(graphed)
            e, n_e = grew(eager)
            check(same_bits(g, e), f"{name}: the graph's outputs differ from the eager body's")
            check(n_g == n_e, f"{name}: the graph counted launches {n_g}, the eager body {n_e}")
            out[name] = n_g
        except (CheckFailure, RuntimeError) as exc:
            if errors is None:
                raise
            errors.append(f"{name}: {type(exc).__name__}: {exc}")
    return out


def sub(cloud, k):
    return type(cloud)(*(f[:k] for f in cloud))


def eager_scan(depths, proj, ccfg, acfg, kf_fraction=0.4, min_cloud_inliers=3000):
    """`odometry_scan` with its stages run eagerly: the reference that its
    graphs are held to."""
    eye = torch.eye(4, dtype=torch.float32, device=depths.device)
    ref = cv._depth_to_cloud(depths[0], proj, ccfg, None)
    _, outs = graphs.iterate(pt._scan_step, (ref, eye, eye), depths[1:], proj, ccfg, acfg, kf_fraction,
                             min_cloud_inliers)
    return pt.scan_outputs(eye, outs)


def check_fresh_outputs(x):
    """Two calls in a row of `align` and `depth_to_cloud` (other inputs
    each time) return tensors that share no storage, and the first
    call's outputs keep their values after the second."""
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    for name, first, second in (
        ("depth_to_cloud", lambda: cv.depth_to_cloud(x["d_ref"], proj, ccfg),
         lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg)),
        ("align", lambda: al.align(x["ref"], x["cur"], proj, None, acfg),
         lambda: al.align(x["cur"], x["ref"], proj, None, acfg)),
    ):
        a = first()
        kept = [t.clone() for t in leaves(a)]
        b = second()
        ptrs = {t.untyped_storage().data_ptr() for t in leaves(a)}
        check(not ptrs & {t.untyped_storage().data_ptr() for t in leaves(b)}, f"{name}: two calls share storage")
        check(same_bits(kept, leaves(a)), f"{name}: the second call changed the first call's outputs")


def check_other_guess(x):
    """align with one initial guess, then another: each equals the eager
    body for its guess."""
    proj, acfg = x["proj"], x["acfg"]
    dev = x["d_ref"].device
    for T in (np.eye(4), np.linalg.inv(x["T_gt"]), lie.se3_exp(torch.tensor([0.02, 0.0, 0.01, 0.0, 0.02, 0.0]))
              .double().numpy()):
        g = al.align(x["ref"], x["cur"], proj, T.astype(np.float32), acfg)
        e = al._align(x["ref"], x["cur"], proj, torch.as_tensor(T, dtype=torch.float32, device=dev), acfg, None)
        check(same_bits(g, e), "align with another initial guess differs from the eager body")


def check_inline(x):
    """`align` called inside an enclosing capture runs inline: no key is
    captured, and the enclosing graph's replay gives the eager result."""
    proj, acfg = x["proj"], x["acfg"]
    n = len(graphs.captures())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        al.align(x["ref"], x["cur"], proj, None, acfg)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        res = al.align(x["ref"], x["cur"], proj, None, acfg)
    check(len(graphs.captures()) == n, "a call inside an enclosing capture captured a graph of its own")
    outer.replay()
    torch.cuda.synchronize()
    check(same_bits(res, al._align(x["ref"], x["cur"], proj, None, acfg, None)),
          "the enclosing graph's align differs from the eager body")


def check_capture_failure(x):
    """A stage whose body reads the host cannot be captured: the call
    raises `CaptureError`, naming the stage and the line, and caches
    nothing."""

    def reads_the_host(depth):
        return depth * float(depth.sum())

    stage = graphs.Stage("reads the host", reads_the_host)
    try:
        stage(x["d_ref"])
    except graphs.CaptureError as exc:
        check("reads the host" in str(exc) and "in reads_the_host" in str(exc), f"the error names no line: {exc}")
        check(not stage._graphs, "a failed capture was cached")
        return str(exc)
    raise CheckFailure("a body that reads the host was captured without an error")


# -- the solvers (solvers/pcg, pose_graph, schur_pcg through graphs.solve_loop) --------------------

# phase 12's world (victoriaPark's counts, 21,662 DOF) and caps, and a small one for the card tests
VICTORIA = dict(n_poses=7120, n_landmarks=151, world_size=60.0, seed=0)
SMALL = dict(n_poses=60, n_landmarks=12, world_size=12.0, seed=3)
SCHUR_CAPS = dict(iters=16, cg_iters=200, lm_lambda0=1e-3)
SMALL_SCHUR_CAPS = dict(iters=6, cg_iters=40, lm_lambda0=1e-3)
BLOCKS = (1, 4, 8, 16, 32)


def solver_worlds(device, small=True):
    """SE2 graphs with and without landmarks (victoriaPark's counts, or a
    60-pose world) and an SE3 graph (bench.py's 300-pose world, or 50
    poses)."""
    from g2o_frontend_tpu_torch.graph.store import graph2d_from_log
    from g2o_frontend_tpu_torch.slam.simulator import Simulator3DConfig, SimulatorConfig, simulate, simulate_se3

    world = simulate(SimulatorConfig(**(SMALL if small else VICTORIA)))
    se3 = (Simulator3DConfig(n_poses=50, world_size=6.0, closure_min_gap=10, seed=2) if small else
           Simulator3DConfig(n_poses=300, seed=0, world_size=20.0, closure_min_gap=50, closure_radius=3.5,
                             closure_prob=0.9))
    return dict(landmarks=graph2d_from_log(world.to_g2o_log(), device=device)[0],
                pose_only=graph2d_from_log(world.to_g2o_log(with_landmarks=False), device=device)[0],
                se3=simulate_se3(se3, device=device)[0])


def solver_cases(w, small=True):
    """name -> a call of one public solver on `solver_worlds`' graphs."""
    from g2o_frontend_tpu_torch.solvers import pose_graph as pg
    from g2o_frontend_tpu_torch.solvers import schur_pcg as sp

    g, g0, g3 = w["landmarks"], w["pose_only"], w["se3"]
    caps = SMALL_SCHUR_CAPS if small else SCHUR_CAPS
    pcg_caps = dict(iters=4, cg_iters=30) if small else dict(iters=10, cg_iters=60)
    cases = {f"optimize_se2_schur, woodbury {wb}": (lambda wb=wb: sp.optimize_se2_schur(g, woodbury=wb, **caps))
             for wb in (True, False)}
    for p in ("jacobi", "chain"):
        cases[f"optimize_se2 {p}"] = lambda p=p: pg.optimize_se2(g0 if not small else g, precond=p, **pcg_caps)
        cases[f"optimize_se3 {p}"] = lambda p=p: pg.optimize_se3(g3, iters=10 if not small else 3,
                                                                  cg_iters=100 if not small else 30, precond=p)
    cases["optimize_se2_direct"] = lambda: pg.optimize_se2_direct(g, iters=8 if small else 30)
    cases["landmark_covariance_se2"] = lambda: sp.landmark_covariance_se2(g)
    return cases


def line_world(n_poses=6, seed=17):
    """A square room's 4 wall lines seen from a short walk
    (tests/test_line_slam.py:20's problem): (poses, lines, pose-pose
    edges, pose-line edges), the poses and lines perturbed."""
    rng = np.random.default_rng(seed)
    lines = np.array([[0.0, 4.0], [np.pi / 2, 4.0], [np.pi, 4.0], [-np.pi / 2, 4.0]])
    poses = [np.zeros(3)]
    for _ in range(n_poses - 1):
        poses.append(poses[-1] + np.array([0.4, 0.1, 0.2]))
    info2, info3 = np.diag([400.0, 100.0]), np.diag([100.0, 100.0, 400.0])
    pl = []
    for i, x in enumerate(poses):
        for l, (alpha, rho) in enumerate(lines):
            z = np.array([alpha - x[2], rho - np.cos(alpha) * x[0] - np.sin(alpha) * x[1]])
            pl.append((i, l, z + rng.normal(0, 0.01, 2), info2))
    pp = []
    for i in range(n_poses - 1):
        d, (c, s) = poses[i + 1] - poses[i], (np.cos(poses[i][2]), np.sin(poses[i][2]))
        pp.append((i, i + 1, np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], d[2]]), info3))
    init = np.asarray([poses[0]] + [p + rng.normal(0, 0.08, 3) for p in poses[1:]])
    return init, lines + rng.normal(0, 0.05, lines.shape), pp, pl


def landmark_cases(device):
    """name -> a call of a landmark solver (line SLAM's graph, the plane
    graph, BA) on a small padded problem."""
    import chip_smoke
    from g2o_frontend_tpu_torch.solvers import ba as tba
    from g2o_frontend_tpu_torch.solvers import line_slam as tls
    from g2o_frontend_tpu_torch.solvers import plane_slam as tps

    gl = tls.make_line_graph(*line_world(), device=device)
    _, _, poses7, planes, pp, pl = chip_smoke.plane_world(n_poses=40, planes=chip_smoke.random_planes(12, 4),
                                                          per_pose=4, step=0.05, seed=5)
    gp = tps.make_plane_graph(poses7, planes, pp, pl, device=device)
    _, _, poses7, points, obs = chip_smoke.ba_world(n_poses=20, n_points=200, per_point=5, seed=3)
    ba = tba.make_ba_problem(poses7, points, obs, device=device)
    return {"optimize_line_graph": lambda: tls.optimize_line_graph(gl, iters=8, cg_iters=50),
            "optimize_plane_graph": lambda: tps.optimize_plane_graph(gp, iters=6, cg_iters=60),
            "optimize_ba": lambda: tba.optimize_ba(ba, iters=6, cg_iters=40)}


def stage_cases(device):
    """name -> (a call of a per-frame stage of tracker2d and line SLAM, the
    same call of its eager body) on small inputs on `device`; the
    association twice, in two buckets of shapes."""
    from g2o_frontend_tpu_torch.laser import line_extraction as tle
    from g2o_frontend_tpu_torch.ransac import engine as tengine
    from g2o_frontend_tpu_torch.ransac import solvers as rsolvers
    from g2o_frontend_tpu_torch.slam import constellation as tcon
    from g2o_frontend_tpu_torch.slam import feature_tracker as tft

    def t(a):
        return torch.as_tensor(a, device=device)

    def association(seed, O=13, OC=16, LC=32):
        rng = np.random.default_rng(seed)
        obs = rng.uniform(-5, 5, (OC, 2)).astype(np.float32)
        lms = np.concatenate([obs[:10] + rng.normal(0, 0.2, (10, 2)), rng.uniform(-5, 5, (LC - 10, 2))])
        S = rng.normal(0, 0.3, (LC, 2, 2))
        Sinv = np.linalg.inv(S @ S.transpose(0, 2, 1) + 0.05 * np.eye(2)).astype(np.float32)
        return t(obs), t(np.arange(OC) < O), t(lms.astype(np.float32)), t(rng.random(LC) < 0.8), t(Sinv)

    o, om, l, lm, Si = association(0)
    o2, om2, l2, lm2, _ = association(1, O=20, OC=32, LC=64)
    rng = np.random.default_rng(2)
    src = rng.uniform(-5, 5, (16, 2)).astype(np.float32)
    c, s = np.cos(0.4), np.sin(0.4)
    tgt = (src @ np.array([[c, -s], [s, c]], np.float32).T + np.array([0.3, -0.2], np.float32)).astype(np.float32)
    tgt[:3] += 2.0  # 3 outliers among the 11 valid pairs
    mask = np.arange(16) < 11
    sets = tengine._sample_minimal_sets(torch.Generator().manual_seed(2), 128, 2, torch.as_tensor(mask)).to(device)
    ransac = (t(tgt), t(src), t(mask), sets, rsolvers.fit_se2_points, rsolvers.err_se2_points, 0.25, 2)
    T = t(np.random.default_rng(3).uniform(-1, 1, (64, 3)).astype(np.float32))
    angles = np.linspace(-np.pi, np.pi, 360, endpoint=False).astype(np.float32)
    ranges = (4.0 / np.maximum(np.abs(np.cos(angles)), np.abs(np.sin(angles)))).astype(np.float32)  # a square room
    r, a = t(ranges), t(angles)
    return {
        "associate_nn": (lambda: tft._associate_nn(o, om, l, lm, 1.0),
                         lambda: tft._associate_nn_body(o, om, l, lm, 1.0)),
        "associate_nn, another bucket": (lambda: tft._associate_nn(o2, om2, l2, lm2, 1.0),
                                         lambda: tft._associate_nn_body(o2, om2, l2, lm2, 1.0)),
        "associate_nn_mahal": (lambda: tft._associate_nn_mahal(o, om, l, lm, Si, 9.21, 10.0),
                               lambda: tft._associate_nn_mahal_body(o, om, l, lm, Si, 9.21, 10.0)),
        "ransac": (lambda: tengine.ransac(None, *ransac[:3], fit_fn=ransac[4], err_fn=ransac[5], minimal_size=2,
                                          inlier_threshold=0.25, n_hypotheses=128, min_inliers=2, minimal_sets=sets),
                   lambda: tengine._ransac(*ransac)),
        "score_hypotheses": (lambda: tcon._score_hypotheses(T, o[:8], om[:8], l[:16], lm[:16], 0.25),
                             lambda: tcon._score_hypotheses_body(T, o[:8], om[:8], l[:16], lm[:16], 0.25)),
        "extract_lines": (lambda: tle.extract_lines(r, a), lambda: tle._extract_lines(r, a, tle.LineExtractorConfig())),
    }


def check_landmark_stages(device):
    """Each per-frame stage's first three calls (its capture, at the first
    call or, for the RANSAC, the second, then replays) bit-equal to its
    eager body, and to the stage in "eager" mode. Returns the names
    checked."""
    cases = stage_cases(device)
    for name, (stage, body) in cases.items():
        want = leaves(body())
        for i, got in enumerate((stage(), stage(), stage())):
            check(same_bits(leaves(got), want), f"{name}: graphed call {i + 1} differs from its eager body")
        with graphs.mode("eager"):
            check(same_bits(leaves(stage()), want), f"{name}: the eager mode differs from its eager body")
    return list(cases)


# -- grid SLAM's matching (laser/scan_matcher, matcher_refine) and the distributed solvers (parallel/) ----------

def grid_stage_cases(device, n_points=360, seed=0, cells=400):
    """name -> (a call of one of grid SLAM's stages, the same call of its
    eager body) on a simulated room scan matched into a `cells` x `cells`
    map at 0.05 m (grid SLAM's is 800 x 800), the scan padded to its
    power-of-two bucket as `slam.grid_slam` pads it (`gradient_refine`
    takes it unpadded)."""
    from g2o_frontend_tpu_torch.laser import matcher_refine as mr
    from g2o_frontend_tpu_torch.laser import scan_matcher as sm
    from g2o_frontend_tpu_torch.slam.grid_slam import _pad_pow2_pts

    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n_points, endpoint=False).astype(np.float32)
    ranges = (4.0 / np.maximum(np.abs(np.cos(angles)), np.abs(np.sin(angles)))
              + rng.normal(0, 0.01, n_points)).astype(np.float32)
    pts = np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1)
    spec = sm.GridSpec(rows=cells, cols=cells, resolution=0.05, origin_x=-0.025 * cells, origin_y=-0.025 * cells)
    pad, n = _pad_pow2_pts(pts, min_cap=1024)
    map_pts, map_valid = torch.as_tensor(pad, device=device), torch.arange(len(pad), device=device) < n
    m = sm._build_likelihood_map(map_pts, map_valid, spec, 1.5)
    c, s_ = np.cos(0.03), np.sin(0.03)
    scan = (pts @ np.array([[c, -s_], [s_, c]], np.float32).T + np.array([0.12, -0.07], np.float32)).astype(np.float32)
    spad, sn = _pad_pow2_pts(scan)
    sp_, sv = torch.as_tensor(spad, device=device), torch.arange(len(spad), device=device) < sn
    thetas = torch.as_tensor(np.deg2rad(np.arange(-10, 11, 1.0)).astype(np.float32) - 0.03, device=device)
    prior = torch.as_tensor(np.array([-0.1, 0.05], np.float32), device=device)
    raw, raw_valid = torch.as_tensor(scan, device=device), torch.ones(len(scan), dtype=torch.bool, device=device)
    pose0 = torch.as_tensor(np.array([-0.1, 0.06, -0.02], np.float32), device=device)
    return {
        "build_likelihood_map": (lambda: sm.build_likelihood_map(map_pts, map_valid, spec, 1.5),
                                 lambda: sm._build_likelihood_map(map_pts, map_valid, spec, 1.5)),
        "correlative_match": (lambda: sm.correlative_match(m, sp_, sv, spec, thetas, 12, prior),
                              lambda: sm._correlative_match(m, sp_, sv, spec, thetas, 12, prior)),
        "correlative_match_multires": (lambda: sm.correlative_match_multires(m, sp_, sv, spec, thetas, 30, prior),
                                       lambda: sm._correlative_match_multires(m, sp_, sv, spec, thetas, 30, prior, 4)),
        "correlative_match_multires, the loop radius": (
            lambda: sm.correlative_match_multires(m, sp_, sv, spec, thetas, 80, prior),
            lambda: sm._correlative_match_multires(m, sp_, sv, spec, thetas, 80, prior, 4)),
        "gradient_refine": (lambda: mr.gradient_refine(m, raw, raw_valid, spec, pose0, steps=3),
                            lambda: mr._gradient_refine(m, raw, raw_valid, spec, pose0, 3, 0.05)),
    }


def check_grid_stages(device):
    """Each of grid SLAM's stages bit-equal to its eager body over three
    calls (its capture, at the first call or, for `gradient_refine`, the
    second, then replays) and in "eager" mode. Returns the names checked."""
    cases = grid_stage_cases(device)
    for name, (stage, body) in cases.items():
        want = leaves(body())
        for i, got in enumerate((stage(), stage(), stage())):
            check(same_bits(leaves(got), want), f"{name}: graphed call {i + 1} differs from its eager body")
        with graphs.mode("eager"):
            check(same_bits(leaves(stage()), want), f"{name}: the eager mode differs from its eager body")
    return list(cases)


# name -> (module of g2o_frontend_tpu_torch.parallel, function, world, caps) at test size
PARALLEL = {
    "optimize_se2_sharded": ("sharded_pose_graph", "optimize_se2_sharded", "landmarks", dict(iters=3, cg_iters=40)),
    "optimize_se3_sharded": ("sharded_pose_graph3d", "optimize_se3_sharded", "se3", dict(iters=3, cg_iters=40)),
    "optimize_ba_sharded": ("sharded_ba", "optimize_ba_sharded", "ba", dict(iters=4, cg_iters=30)),
    "optimize_se2_partitioned jacobi": ("partitioned_pose_graph", "optimize_se2_partitioned", "landmarks",
                                        dict(iters=3, cg_iters=40, precond="jacobi")),
    "optimize_se2_partitioned chain": ("partitioned_pose_graph", "optimize_se2_partitioned", "landmarks",
                                       dict(iters=3, cg_iters=60, precond="chain")),
    "optimize_se3_partitioned jacobi": ("partitioned_pose_graph", "optimize_se3_partitioned", "se3",
                                        dict(iters=3, cg_iters=40, precond="jacobi")),
    "optimize_se3_partitioned spike": ("partitioned_pose_graph", "optimize_se3_partitioned", "se3",
                                       dict(iters=3, cg_iters=40, precond="spike")),
    "optimize_se2_schur_partitioned": ("partitioned_schur", "optimize_se2_schur_partitioned", "landmarks",
                                       dict(iters=8, cg_iters=40, lm_lambda0=1e-3)),
    "optimize_se2_schur_partitioned, pose only": ("partitioned_schur", "optimize_se2_schur_partitioned",
                                                  "pose_only", dict(iters=8, cg_iters=40, lm_lambda0=1e-3)),
}


def parallel_worlds(device):
    """`solver_worlds`' small graphs and a 10-pose, 80-point BA problem."""
    import chip_smoke
    from g2o_frontend_tpu_torch.solvers import ba as tba

    w = solver_worlds(device)
    _, _, poses7, points, obs = chip_smoke.ba_world(n_poses=10, n_points=80, per_point=4, seed=3)
    w["ba"] = tba.make_ba_problem(poses7, points, obs, device=device)
    return w


def parallel_cases(device, n_dev=8, worlds=None, function=None):
    """name -> a call of one distributed solver (`PARALLEL`) on a
    `StackedMesh(n_dev)` on `device`; `function(name)` gives the function
    to call in the module's stead (a test's copy of the loop before it
    ran through `solve_loop`)."""
    import importlib

    from g2o_frontend_tpu_torch.parallel.mesh import StackedMesh

    w = parallel_worlds(device) if worlds is None else worlds
    cases = {}
    for name, (mod, fn, world, caps) in PARALLEL.items():
        f = (getattr(importlib.import_module(f"g2o_frontend_tpu_torch.parallel.{mod}"), fn) if function is None
             else function(fn))
        cases[name] = lambda f=f, world=world, caps=caps: f(w[world], StackedMesh(n_dev, device), **caps)
    return cases


def solver_leaves(out):
    """The tensors and counts of a solver's result, for `same_bits`."""
    if torch.is_tensor(out):
        return [out]
    if len(out) == 3:  # a partitioned solver's (graph, chi2 trace, stats)
        gk, trace, stats = out
        return solver_leaves((gk, trace)) + [torch.tensor([stats["cg_total"], stats.get("lm_iters", 0)])]
    gk, st = out
    if torch.is_tensor(st):  # a landmark or distributed solver's (graph, chi2 trace)
        return graphs.flatten(gk)[1] + [st]
    rest = [gk.landmarks] if hasattr(gk, "landmarks") else []
    counts = [torch.tensor([v]) for v in st if isinstance(v, int)]
    return [gk.poses] + rest + [t for t in st if torch.is_tensor(t)] + counts


def check_solvers(device, small=True, errors=None, cases=None):
    """Each solver's graphed calls (the first with its key: eager head and
    tail, its CG blocks through a graph; the second, which captures the
    chain; the third, a replay) bit-equal to one another and to the solve
    in "eager" mode (the eager port: a host read a CG iteration), and its
    segment-sum launches under replay equal to a run of the same masked
    steps eagerly ("masked" mode). Returns {name: (graph launches, eager
    launches, host reads graphed, host reads eager)}."""
    from g2o_frontend_tpu_torch.ops import segment_sum as ss

    out = {}
    for name, fn in (cases or solver_cases(solver_worlds(device, small), small)).items():
        try:
            runs = [solver_leaves(fn()) for _ in range(2)]
            ss.launches, graphs.host_reads = 0, 0
            runs.append(solver_leaves(fn()))
            n_graph, reads_graph = ss.launches, graphs.host_reads
            with graphs.mode("masked"):
                ss.launches = 0
                masked = solver_leaves(fn())
                n_masked = ss.launches
            with graphs.mode("eager"):
                ss.launches, graphs.host_reads = 0, 0
                eager = solver_leaves(fn())
                n_eager, reads_eager = ss.launches, graphs.host_reads
            for i, r in enumerate(runs):
                check(same_bits(r, eager), f"{name}: graphed call {i + 1} differs from the eager mode")
            check(same_bits(masked, eager), f"{name}: the masked mode differs from the eager mode")
            check(n_graph == n_masked, f"{name}: a replayed solve counted {n_graph} launches, its masked steps "
                  f"run eagerly {n_masked}")
            out[name] = (n_graph, n_eager, reads_graph, reads_eager)
        except (CheckFailure, RuntimeError) as exc:
            if errors is None:
                raise
            errors.append(f"{name}: {type(exc).__name__}: {exc}")
    return out


def check_solver_capture_failure(device):
    """A solve whose head reads the host cannot be captured: its second call
    (the chain's capture) raises `CaptureError` naming the piece and the
    line, and keeps no chain."""
    x = torch.arange(8.0, device=device)

    def head(inputs, st):
        return inputs * float(st.sum()), None  # reads the host

    solve = graphs.Solve(head, lambda inputs, st, mid, carry: st + mid, lambda st: st[:1].long())
    graphs.solve_loop("reads the host", solve, x, x, 2)
    try:
        graphs.solve_loop("reads the host", solve, x, x, 2)
    except graphs.CaptureError as exc:
        check("reads the host: head" in str(exc) and "in head" in str(exc), f"the error names no line: {exc}")
        check(not any(k[0] == "reads the host" for k in graphs._CHAINS), "a failed capture was kept")
        return str(exc)
    raise CheckFailure("a head that reads the host was captured without an error")


def solve_turns(name, fn, n=1):
    """A whole solve graphed against its eager mode in turns (eager, graph,
    graph, eager), each by one pair of CUDA events (n=1) or the median of
    n; the graphed key captured before."""
    fn()
    fn()

    def eager():
        with graphs.mode("eager"):
            return fn()

    e1, g1, g2, e2 = (float(np.median(event_ms(f, n))) for f in (eager, fn, fn, eager))
    return {"solve": name, "graph_ms": min(g1, g2), "eager_ms": min(e1, e2), "graph_runs_ms": [g1, g2],
            "eager_runs_ms": [e1, e2], "speedup": min(e1, e2) / min(g1, g2)}


def event_ms(fn, runs):
    """Per-run milliseconds of `fn` by CUDA events, no warm-up call."""
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def block_sweep(device, blocks=BLOCKS):
    """`pcg.BLOCK` in turns over `blocks` on the Schur solve at victoriaPark's
    counts and on the pose-only chain-preconditioned solve: for each B the
    whole graphed solve by CUDA events (the key captured before: the
    lesser of two passes, forward then backward), the host reads a solve
    and the masked CG steps beyond the eager count."""
    from g2o_frontend_tpu_torch.solvers import pcg
    from g2o_frontend_tpu_torch.solvers import pose_graph as pg
    from g2o_frontend_tpu_torch.solvers import schur_pcg as sp

    w = solver_worlds(device, small=False)
    solves = {"schur": lambda: sp.optimize_se2_schur(w["landmarks"], **SCHUR_CAPS),
              "se2 chain": lambda: pg.optimize_se2(w["pose_only"], iters=10, cg_iters=60, precond="chain")}
    rows, before = [], pcg.BLOCK
    try:
        for name, fn in solves.items():
            times, reads, outs = {}, {}, {}
            for order in (blocks, tuple(reversed(blocks))):
                for b in order:
                    pcg.BLOCK = b
                    if b not in times:
                        fn()
                        fn()  # the key (its block is part of it) captured
                    graphs.host_reads = 0
                    box = []
                    times.setdefault(b, []).append(event_ms(lambda: box.append(fn()), 1)[0])
                    reads[b], outs[b] = graphs.host_reads, box[0][1]
            for b in blocks:
                lm = getattr(outs[b], "lm_iters", 10)
                rows.append({"solve": name, "block": b, "ms": min(times[b]), "runs_ms": times[b],
                             "host_reads": reads[b], "cg_iters": outs[b].cg_iters, "lm_iters": lm,
                             "masked_steps_at_most": lm * (b - 1)})
    finally:
        pcg.BLOCK = before
    return rows


def turns(name, graphed, eager, n):
    """Graph and eager in turns (eager, graph, graph, eager), each the
    median ms of n whole calls by CUDA events; device ms by torch.profiler
    and the device's idle share of a call."""
    from g2o_frontend_tpu_torch.utils.profiling import device_ms, event_ms

    e1, g1, g2, e2 = (float(np.median(event_ms(f, n))) for f in (eager, graphed, graphed, eager))
    row = {"stage": name, "graph_ms": min(g1, g2), "eager_ms": min(e1, e2), "graph_runs_ms": [g1, g2],
           "eager_runs_ms": [e1, e2], "eager_device_ms": device_ms(eager, 5)}
    try:
        row["graph_device_ms"] = device_ms(graphed, 5)
    except RuntimeError:  # the profiler saw no kernel of the replays
        row["graph_device_ms"] = None
    row["speedup"] = row["eager_ms"] / row["graph_ms"]
    row["graph_idle_share"] = 1.0 - (row["graph_device_ms"] or row["eager_device_ms"]) / row["graph_ms"]
    row["eager_idle_share"] = 1.0 - row["eager_device_ms"] / row["eager_ms"]
    return row


def timing(device, n=20):
    """The four stages at 640x480, graph against eager (`turns`)."""
    x = inputs(device, K=21)
    proj, ccfg, acfg = x["proj"], x["ccfg"], x["acfg"]
    rows = [turns("depth_to_cloud", lambda: cv.depth_to_cloud(x["d_cur"], proj, ccfg),
                  lambda: cv._depth_to_cloud(x["d_cur"], proj, ccfg, None), n),
            turns("align", lambda: al.align(x["ref"], x["cur"], proj, None, acfg),
                  lambda: al._align(x["ref"], x["cur"], proj, None, acfg, None), n)]
    for K in (8, 21):
        refs, guesses = sub(x["refs"], K), x["guesses"][:K]
        rows.append(turns(f"align_batch K={K}", lambda: al.align_batch(refs, x["cur"], proj, guesses, acfg),
                          lambda: al._align_batch(refs, x["cur"], proj, guesses, acfg), max(n // 2, 5)))
    return rows


def nccl_capture(device):
    """Every `PARALLEL` solver on a `ProcessMesh` over NCCL at world size 1
    (this process the one rank), called three times: the key seen once,
    the chain's capture, a replay; each against the solve in "eager"
    mode. Returns {name: "bit-equal" or the error}: this is where a
    capture that NCCL refuses shows."""
    import importlib
    import socket

    import torch.distributed as dist

    from g2o_frontend_tpu_torch.parallel.mesh import ProcessMesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=device)
    out = {}
    try:
        w = parallel_worlds(device)
        for name, (mod, fn, world, caps) in PARALLEL.items():
            f = getattr(importlib.import_module(f"g2o_frontend_tpu_torch.parallel.{mod}"), fn)
            pm = ProcessMesh(device)  # a key holds its mesh: one object, so that the second call captures the chain
            try:
                runs = [solver_leaves(f(w[world], pm, **caps)) for _ in range(3)]
                with graphs.mode("eager"):
                    eager = solver_leaves(f(w[world], pm, **caps))
                out[name] = "bit-equal" if all(same_bits(r, eager) for r in runs) else "differs from the eager mode"
            except Exception as exc:  # the probe reports a refused capture; the package raises it
                out[name] = f"{type(exc).__name__}: {str(exc)[:400]}"
    finally:
        dist.destroy_process_group()
    return out


def grid_timing(device, n=20):
    """Each grid SLAM stage at grid SLAM's 800 x 800 map, graph against
    eager (`turns`)."""
    rows = []
    for name, (stage, body) in grid_stage_cases(device, cells=800).items():
        stage(), stage()  # captured (the refinement at its second call)
        rows.append(turns(name, stage, body, n))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-timing", action="store_true", help="run the checks only")
    ap.add_argument("--solvers", action="store_true", help="the solvers only: their checks on a small world and at "
                    "victoriaPark's counts, the failed capture, the block sweep, graph against eager in turns")
    ap.add_argument("--grid", action="store_true", help="grid SLAM's stages only: their checks, then graph against "
                    "eager in turns at 800 x 800")
    ap.add_argument("--parallel", action="store_true", help="the distributed solvers only: their checks on "
                    "StackedMesh(8), graph against eager in turns, then a ProcessMesh over NCCL at world size 1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("graph_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    device = torch.device("cuda:0")
    errors = []
    if args.grid or args.parallel:
        return probe_slices(device, args, smi, errors)
    if not args.solvers:
        for H, W in ((120, 160), (480, 640)):
            x = inputs(device, H, W)
            launches = check_stages(x, errors=errors)
            for fn in (check_fresh_outputs, check_other_guess, check_inline):
                try:
                    fn(x)
                except (CheckFailure, RuntimeError) as exc:
                    errors.append(f"{fn.__name__}: {type(exc).__name__}: {exc}")
            print(json.dumps({"checks": f"{H}x{W}", "launches": launches, "errors": errors}), flush=True)
        print(json.dumps({"capture_failure": check_capture_failure(x)}), flush=True)
        if not args.no_timing:
            for row in timing(device):
                print(json.dumps({**row, "gpu": smi}), flush=True)
    for small in (True, False):
        got = check_solvers(device, small, errors)
        print(json.dumps({"solver checks": "small" if small else "victoriaPark's counts", "launches and host reads "
                          "(graph launches, eager launches, graph reads, eager reads)": got, "errors": errors}),
              flush=True)
    got = check_solvers(device, errors=errors, cases=landmark_cases(device))
    print(json.dumps({"solver checks": "landmark graphs", "launches and host reads": got, "errors": errors}),
          flush=True)
    try:
        print(json.dumps({"stage checks": check_landmark_stages(device)}), flush=True)
    except (CheckFailure, RuntimeError) as exc:
        errors.append(f"check_landmark_stages: {type(exc).__name__}: {exc}")
    print(json.dumps({"solver capture_failure": check_solver_capture_failure(device)}), flush=True)
    if not args.no_timing:
        for row in block_sweep(device):
            print(json.dumps({**row, "gpu": smi}), flush=True)
        for name, fn in solver_cases(solver_worlds(device, small=False), small=False).items():
            print(json.dumps({**solve_turns(name, fn), "gpu": smi}), flush=True)
    for c in graphs.captures():
        print(json.dumps({"capture": c.stage, "shapes": c.shapes[:4], "capture_ms": c.capture_ms,
                          "pool_bytes": c.pool_bytes, "input_bytes": c.input_bytes, "launches": c.launches,
                          "kept": c.kept}), flush=True)
    print(smi, flush=True)
    return 1 if errors else 0


def probe_slices(device, args, smi, errors):
    """`--grid` and `--parallel`: their checks, timings and captures."""
    if args.grid:
        try:
            print(json.dumps({"grid stage checks": check_grid_stages(device)}), flush=True)
        except (CheckFailure, RuntimeError) as exc:
            errors.append(f"check_grid_stages: {type(exc).__name__}: {exc}")
        if not args.no_timing:
            for row in grid_timing(device):
                print(json.dumps({**row, "gpu": smi}), flush=True)
    if args.parallel:
        cases = parallel_cases(device)
        got = check_solvers(device, errors=errors, cases=cases)
        print(json.dumps({"solver checks": "distributed, StackedMesh(8)", "launches and host reads (graph launches, "
                          "eager launches, graph reads, eager reads)": got, "errors": errors}), flush=True)
        if not args.no_timing:
            for name, fn in cases.items():
                print(json.dumps({**solve_turns(name, fn), "gpu": smi}), flush=True)
        print(json.dumps({"ProcessMesh over NCCL, world size 1": nccl_capture(device)}), flush=True)
    for c in graphs.captures():
        print(json.dumps({"capture": c.stage, "shapes": c.shapes[:4], "capture_ms": c.capture_ms,
                          "pool_bytes": c.pool_bytes, "input_bytes": c.input_bytes, "launches": c.launches,
                          "kept": c.kept}), flush=True)
    print(json.dumps({"errors": errors}), flush=True)
    print(smi, flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
