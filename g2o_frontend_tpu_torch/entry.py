"""The system's own entry points (counterpart of ``__graft_entry__.py``):
the flagship step and the multi-device dry run.

- `entry(device)` returns ``(fn, (depth_ref, depth_cur))``: `fn` is one PWN
  dense point-with-normal alignment (a 120x160 depth pair -> clouds ->
  ``align`` with 5 outer iterations -> ``(T, omega, inliers)``), the pair
  on `device`. On the card it runs kernel 1 (``csrc/fused_aligner.cu``).
- `dryrun_multichip(n_devices, device)` runs the distributed solvers on a
  `StackedMesh` of `n_devices` shards on `device`, at the JAX dry run's
  sizes where it needs no dataset, with its asserts, and prints its
  summary line. It returns each step's chi2 traces.

Like the package ``__init__``, the module imports only torch when it is
imported.

    python -c "from g2o_frontend_tpu_torch.entry import entry; fn, a = entry(); print(fn(*a))"
    python -c "from g2o_frontend_tpu_torch.entry import dryrun_multichip; dryrun_multichip(8)"
"""
from __future__ import annotations

import torch


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _small_graph(n=64, n_loop=8, device="cuda"):
    """A noisy circle of `n` SE2 poses with `n_loop` loop edges across it
    (the JAX dry run's graph, at its exact counts)."""
    import numpy as np

    from .graph.store import graph2d_from_log
    from .io.g2o import G2OLog

    rng = np.random.default_rng(0)
    gt = np.zeros((n, 3))
    for i in range(n):
        th = 2 * np.pi * i / n
        gt[i] = [10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2]

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth])

    ij, z = [], []
    for i in range(n - 1):
        ij.append([i, i + 1])
        z.append(rel(gt[i], gt[i + 1]) + rng.normal(0, 0.03, 3))
    for _ in range(n_loop):
        i = int(rng.integers(0, n))
        j = (i + n // 2) % n
        ij.append([min(i, j), max(i, j)])
        z.append(rel(gt[min(i, j)], gt[max(i, j)]))
    log = G2OLog(
        se2_ids=np.arange(n),
        se2_poses=gt + rng.normal(0, 0.1, gt.shape),
        edge_se2_ij=np.asarray(ij),
        edge_se2_meas=np.asarray(z),
        edge_se2_info=np.tile(np.diag([100.0, 100.0, 400.0]), (len(ij), 1, 1)),
        fixed_ids=np.array([0]),
    )
    g, _ = graph2d_from_log(log, device=device)
    return g


def flagship_configs():
    """(projector, converter config, aligner config) of the flagship step:
    a 120x160 camera, the reference's scale-4 statistics radii, 5 outer
    iterations."""
    from .pwn.aligner import AlignerConfig
    from .pwn.converter import ConverterConfig
    from .pwn.projector import PinholeProjector

    H, W = 120, 160
    proj = PinholeProjector(rows=H, cols=W, fx=131.25, fy=131.25, cx=W / 2 - 0.5, cy=H / 2 - 0.5, min_distance=0.1,
                            max_distance=10.0)
    return proj, ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12), AlignerConfig(
        outer_iterations=5)


def entry(device="cuda"):
    """(fn, example_args): the flagship forward step, PWN dense
    point-with-normal alignment (depth pair -> relative transform,
    information, inliers)."""
    import numpy as np

    from .pwn.aligner import align
    from .pwn.converter import depth_to_cloud

    proj, ccfg, acfg = flagship_configs()
    base = 2.0 + 0.5 * np.sin(np.linspace(0, 3, proj.cols))[None, :]
    depth_ref = torch.as_tensor(np.broadcast_to(base, (proj.rows, proj.cols)).astype(np.float32), device=device)
    depth_cur = depth_ref * 1.01

    def fn(d_ref, d_cur):
        ref = depth_to_cloud(d_ref, proj, ccfg)
        cur = depth_to_cloud(d_cur, proj, ccfg)
        res = align(ref, cur, proj, config=acfg)
        return res.T, res.omega, res.inliers

    return fn, (depth_ref, depth_cur)


def _ba_dryrun_problem(device):
    """The dry run's BA problem: 4 poses observing 24 points, every pose
    sees every point, the points perturbed by 5 cm."""
    import numpy as np

    from .solvers.ba import make_ba_problem
    from .utils import lie

    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (24, 3))
    poses_gt = [
        lie.se3_exp(torch.as_tensor(np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.2, 0.2, 3)]),
                                    dtype=torch.float32)).numpy()
        for _ in range(4)
    ]
    obs = []
    for i, T in enumerate(poses_gt):
        Ti = np.linalg.inv(T)
        for l, p in enumerate(pts):
            obs.append((i, l, Ti[:3, :3] @ p + Ti[:3, 3], np.eye(3) * 100))
    poses7 = []
    for T in poses_gt:
        q = lie.mat2quat_full(torch.as_tensor(T[:3, :3], dtype=torch.float32)).numpy()
        poses7.append(np.concatenate([T[:3, 3], q[1:], q[:1]]))
    return make_ba_problem(poses7, pts + rng.normal(0, 0.05, pts.shape), obs, device=device)


DRYRUN_SE3_WORLD = dict(n_poses=160, seed=0, world_size=18.0, closure_min_gap=40, closure_radius=3.5,
                        closure_prob=0.9)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded and partitioned solvers over `n_devices` stacked shards:
    (a) edge-sharded SE2 LM; (a2) the partitioned solver with block-Jacobi
    and chain preconditioners against the single-device one; (a3) the
    distributed Schur solver; (a5) SE3 SPIKE on a 160-pose world against
    the float64 control; (b) observation-sharded BA. Returns each step's
    chi2 trace (and the controls and partition stats)."""
    import math

    from .parallel.mesh import StackedMesh
    from .parallel.partitioned_pose_graph import optimize_se2_partitioned, optimize_se3_partitioned
    from .parallel.partitioned_schur import optimize_se2_schur_partitioned
    from .parallel.sharded_ba import optimize_ba_sharded
    from .parallel.sharded_pose_graph import optimize_se2_sharded
    from .slam.simulator import Simulator3DConfig, simulate_se3
    from .solvers.control import control_optimize_se3
    from .solvers.pose_graph import optimize_se2

    mesh = StackedMesh(n_devices, device)
    out = {}

    # (a) edge-sharded pose graph
    _, out["sharded_se2"] = optimize_se2_sharded(_small_graph(n=32, n_loop=4, device=device), mesh, iters=1,
                                                 cg_iters=10)
    chi = float(out["sharded_se2"][-1])
    _require(math.isfinite(chi), f"sharded SE2 chi2 {chi}")

    # (a2) the partitioned-state solver (ghost halo exchange) against the
    # single-device solver; the block-local chain preconditioner does at
    # least as well as block-Jacobi at the same budget
    gv = _small_graph(n=256, n_loop=16, device=device)
    _, st_ref = optimize_se2(gv, iters=2, cg_iters=40)
    _, out["partitioned_jacobi"], pstats = optimize_se2_partitioned(gv, mesh, iters=2, cg_iters=40)
    out["single_device"], out["partition"] = st_ref.chi2, pstats["partition"]
    chi_ref, chi_pt = float(st_ref.chi2[-1]), float(out["partitioned_jacobi"][-1])
    _require(abs(chi_pt - chi_ref) / max(chi_ref, 1e-9) < 0.05, f"partitioned {chi_pt} vs single device {chi_ref}")
    part = pstats["partition"]
    _require(part["bytes_sharded_per_device"] < part["bytes_full_graph"], f"partition {part}")
    _, out["partitioned_chain"], _ = optimize_se2_partitioned(gv, mesh, iters=2, cg_iters=40, precond="chain")
    chi_ch = float(out["partitioned_chain"][-1])
    _require(math.isfinite(chi_ch) and chi_ch <= 1.05 * chi_pt, f"chain {chi_ch} vs jacobi {chi_pt}")

    # (a3) the distributed Schur/chain/Woodbury LM
    _, out["schur"], spstats = optimize_se2_schur_partitioned(gv, mesh, iters=20, cg_iters=40)
    out["schur_stats"] = spstats
    chi_sp = float(out["schur"][-1])
    _require(math.isfinite(chi_sp), f"distributed Schur chi2 {chi_sp}")

    # (a5) distributed SE3 SPIKE on a multi-loop world whose optimum is
    # not zero, against the float64 control
    g3s, _ = simulate_se3(Simulator3DConfig(**DRYRUN_SE3_WORLD), device=device)
    out["se3_control"] = control_optimize_se3(g3s.to("cpu"), max_iters=40)["chi2"]
    _, out["se3_spike"] = optimize_se3_partitioned(g3s, mesh, iters=20, cg_iters=80, precond="spike")
    chi3s = float(out["se3_spike"][-1])
    _require(math.isfinite(chi3s), f"SE3 SPIKE chi2 {chi3s}")
    _require(chi3s <= 1.01 * out["se3_control"], f"SE3 SPIKE chi2 {chi3s} vs control {out['se3_control']}")

    # (b) observation-sharded Schur BA
    _, out["ba"] = optimize_ba_sharded(_ba_dryrun_problem(device), mesh, iters=1, cg_iters=10)
    chi_ba = float(out["ba"][-1])
    _require(math.isfinite(chi_ba), f"BA chi2 {chi_ba}")
    print(
        f"dryrun_multichip OK on {n_devices} devices; "
        f"pose-graph chi2={chi:.3f}, BA chi2={chi_ba:.3f}, "
        f"partitioned victoriaPark chi2={chi_pt:.1f} "
        f"(single-device {chi_ref:.1f}, "
        f"{part['bytes_sharded_per_device']} sharded B/dev), "
        f"distributed-Schur chi2={chi_sp:.1f} "
        f"({spstats['lm_iters']} LM its, {spstats['cg_total']} CG), "
        f"SE3-sim SPIKE chi2={chi3s:.1f} <= 1.01x control {out['se3_control']:.1f}",
        flush=True,
    )
    return out
