"""The JAX package's line SLAM over phase 14 (b)'s laser world, the
reference count that `chip_smoke.py` holds the port's card run against,
and the lockstep that tells where the port's padded run parts from it.

Without flags: runs `g2o_frontend_tpu.slam.line_slam.LineSlam2D` (JAX, on
the CPU) and the port's `LineSlam2D` on the CPU over the same 452
simulated scans (`chip_smoke.GRID_WORLD`), each followed by
`merge_landmarks` and one final `optimize`, as `chip_smoke.cpu_slice5`
drives the port. Prints one JSON line per package: lines, observations,
ATE rmse (m) against the ground truth and the odometry's, and the seconds
taken.

`--lockstep [--scans N]`: the port with its graph padded as the JAX
package pads it (`solvers.line_slam.make_line_graph`) beside the JAX
package's `LineSlam2D`, both on the CPU in float32, stepped scan by scan
(`lockstep`). Two runs:

- `free`: each package extracts its own lines. Reports the first scan
  whose extracted lines differ, and there the port's lines against the
  JAX package's extraction run op by op (`jax.disable_jit`): the jitted
  JAX program rounds a degenerate segment's float32 moments otherwise;
  then the first scan whose associations differ, and both runs' final
  lines, observations and ATE.
- `shared`: the port is given the JAX package's extracted lines at every
  scan, so that the two runs differ only by their solves. Reports the
  first scan whose associations (landmark index of each observation) or
  count of new lines differ, and at every solve (every `optimize_each_n`
  scans): the gap between the two runs' poses going in and coming out,
  and each solve on the same inputs (`_same_inputs`): the JAX package's
  padded graph solved again by the port (its pose and line gap and its
  chi2 trace against JAX's), the port's solved by the JAX package, and
  both float32 results' pose gap to the JAX package's solve in float64 on
  those inputs (how far rounding alone moves that solve). The free run
  reports its solves the same way.

Prints one JSON line per solve and one per run.

    JAX_PLATFORMS=cpu python tools/jax_line_slam_reference.py
    JAX_PLATFORMS=cpu python tools/jax_line_slam_reference.py --lockstep [--scans 452]

Needs JAX, so it runs beside the tests, never on the machine with the
card.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def drive(drv, world):
    t0 = time.perf_counter()
    for k in range(len(world["scans"])):
        drv.process_scan(*world["scans"][k], world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32))
    merged = drv.merge_landmarks()
    chi2 = drv.optimize()
    return merged, chi2, time.perf_counter() - t0


def _world(n_scans=None):
    from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world

    cfg = dict(chip_smoke.GRID_WORLD)
    if n_scans is not None:
        cfg["n_poses"] = n_scans
    return simulate_laser_world(LaserWorldConfig(**cfg))


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) if len(a) else 0.0


class _Recorder:
    """Wraps a `slam.line_slam` module's `lineset_to_params` and
    `optimize_line_graph` in place: records each scan's extracted lines
    and each solve's input and output graph; `feed`, where set, replaces
    the lines `process_scan` reads (the port fed the JAX package's)."""

    def __init__(self, mod, to_numpy):
        self.mod, self.to_numpy = mod, to_numpy
        self.params = self.feed = None
        self.solves = []
        self._params, self._solve = mod.lineset_to_params, mod.optimize_line_graph
        mod.lineset_to_params, mod.optimize_line_graph = self.lineset_to_params, self.optimize_line_graph

    def lineset_to_params(self, ls):
        self.params = self._params(ls)
        return self.params if self.feed is None else self.feed

    def optimize_line_graph(self, g, **kw):
        out = self._solve(g, **kw)
        self.solves.append((self.to_numpy(g), self.to_numpy(out[0]), np.asarray(out[1], np.float64)))
        return out

    def restore(self):
        self.mod.lineset_to_params, self.mod.optimize_line_graph = self._params, self._solve


def _extraction_equal(a, b, atol=1e-4):
    """Two scans' (params, lengths, mask) agree: the same kept lines, their
    (alpha, rho) within `atol`."""
    (pa, la, ma), (pb, lb, mb) = a, b
    if pa.shape != pb.shape or not np.array_equal(ma, mb):
        return False, np.inf
    keep = ma & (la >= 0.5)
    d = _gap(pa[keep], pb[keep]) if keep.any() else 0.0
    return bool(np.array_equal(keep, mb & (lb >= 0.5)) and d <= atol), d


def _jax_eager_params(jls, scan):
    """The JAX package's extraction of `scan` run op by op."""
    import jax
    import jax.numpy as jnp

    with jax.disable_jit():
        ls = jls.extract_lines(jnp.asarray(scan[0], jnp.float32), jnp.asarray(scan[1], jnp.float32),
                               jls.LineSlam2DConfig().extractor)
    return jls.lineset_to_params(ls)


def _jax_solve(arrays, cfg, jsolve, dtype):
    import jax.numpy as jnp

    g = jsolve.LineGraph(**{k: jnp.asarray(v, dtype if v.dtype.kind == "f" else v.dtype) for k, v in arrays.items()})
    o, tr = jsolve.optimize_line_graph(g, iters=cfg.optimize_iters, cg_iters=cfg.cg_iters)
    return np.asarray(o.poses), np.asarray(o.lines), np.asarray(tr, np.float64)


def _same_inputs(gj_in, gj_out, trj, gt_in, gt_out, cfg, jsolve, tsolve, convert, float64):
    """Each solve on the same inputs: the JAX package's padded input solved
    again by the port (pose and line gap, chi2 trace rtol), and the port's
    padded input solved by the JAX package (`jax_on_port`: pose gap); with
    `float64`, both float32 results' pose gap to the JAX package's solve of
    JAX's input in float64. Gaps over the live rows."""
    import jax
    import jax.numpy as jnp

    n, nl = int(gj_in["pose_mask"].sum()), int(gj_in["line_mask"].sum())
    go, tr = tsolve.optimize_line_graph(convert.line_graph_from_numpy(gj_in, device="cpu"), iters=cfg.optimize_iters,
                                        cg_iters=cfg.cg_iters)
    pt, lt = go.poses.numpy()[:n], go.lines.numpy()[:nl]
    row = {"pose_gap": _gap(pt, gj_out["poses"][:n]), "line_gap": _gap(lt, gj_out["lines"][:nl]),
           "trace_rtol": float(np.max(np.abs(tr.numpy() - trj) / np.abs(trj)))}
    nt = int(gt_in["pose_mask"].sum())
    if {k: v.shape for k, v in gt_in.items()} == {k: v.shape for k, v in gj_in.items()}:
        row["jax_on_port"] = _gap(_jax_solve(gt_in, cfg, jsolve, jnp.float32)[0][:nt], gt_out["poses"][:nt])
    if float64:
        with jax.enable_x64(True):
            p64 = _jax_solve(gj_in, cfg, jsolve, jnp.float64)[0][:n]
        row["jax_f32_to_f64"] = _gap(gj_out["poses"][:n], p64)
        row["port_f32_to_f64"] = _gap(pt, p64)
    return row


def lockstep(n_scans=None, shared=True, float64=True, stop=None):
    """The port padded beside the JAX package, scan by scan (see the module
    docstring): a dict of the run's findings, `solves` one row a solve.
    `stop` (by default in the shared run only): end at the first scan whose
    associations differ, without the final merge and solve."""
    stop = shared if stop is None else stop
    from g2o_frontend_tpu.slam import line_slam as jls
    from g2o_frontend_tpu.solvers import line_slam as jsolve
    from g2o_frontend_tpu_torch import convert
    from g2o_frontend_tpu_torch.slam import line_slam as tls
    from g2o_frontend_tpu_torch.solvers import line_slam as tsolve
    from g2o_frontend_tpu_torch.utils.evaluation import ate_xy

    world = _world(n_scans)
    scans = world["scans"]
    J, T = jls.LineSlam2D(), tls.LineSlam2D(device="cpu")
    exact = tls._line_graph

    def padded(p, l, pp, pl, f, caps, dtype, device):  # the JAX package's capacities, not `caps`
        return tsolve.make_line_graph(p, l, pp, pl, f, dtype, device)

    rj = _Recorder(jls, lambda g: {k: np.asarray(v) for k, v in g._asdict().items()})
    rt = _Recorder(tls, convert.line_graph_to_numpy)
    tls._line_graph = padded
    out = {"run": "shared" if shared else "free", "scans": len(scans), "first_extraction": None,
           "first_association": None, "solves": []}
    t0 = time.perf_counter()
    try:
        for k in range(len(scans)):
            args = (*scans[k], world["odom_deltas"][k - 1] if k else np.zeros(3, np.float32))
            ej, et = len(J.pl_edges), len(T.pl_edges)
            nj = J.process_scan(*args)
            rt.feed = rj.params if shared else None
            nt = T.process_scan(*args)
            same, d = _extraction_equal(rj.params, rt.params)
            if not same and out["first_extraction"] is None:
                eager_same, eager_d = _extraction_equal(_jax_eager_params(jls, scans[k]), rt.params)
                out["first_extraction"] = {"scan": k, "gap": d, "port_equals_jax_op_by_op": eager_same,
                                           "gap_op_by_op": eager_d}
            aj, at = [e[1] for e in J.pl_edges[ej:]], [e[1] for e in T.pl_edges[et:]]
            if out["first_association"] is None and (aj != at or nj != nt):
                out["first_association"] = {"scan": k, "jax": aj, "port": at, "new_jax": nj, "new_port": nt}
                if stop:
                    break
        for drv in (J, T):
            if out["first_association"] is None or not stop:
                drv.merge_landmarks()
                drv.optimize()
    finally:
        rj.restore(), rt.restore()
        tls._line_graph = exact
    out["seconds"] = time.perf_counter() - t0
    gt = world["gt_poses"].astype(np.float64)[: len(J.poses)]
    for name, drv in (("jax", J), ("port", T)):
        st = drv.stats()
        out[name] = {"n_lines": st["n_lines"], "n_obs": st["n_obs"],
                     "ate_rmse_m": float(ate_xy(np.asarray(drv.poses, np.float64)[:, :2], gt[:, :2])["rmse"])}
    cfg = J.cfg
    for s, ((gj_in, gj_out, trj), (gt_in, gt_out, _)) in enumerate(zip(rj.solves, rt.solves)):
        n = int(gj_in["pose_mask"].sum())
        comparable = int(gt_in["pose_mask"].sum()) == n
        row = {"solve": s + 1, "poses": n, "lines_jax": int(gj_in["line_mask"].sum()),
               "lines_port": int(gt_in["line_mask"].sum()),
               "in_gap": _gap(gj_in["poses"][:n], gt_in["poses"][:n]) if comparable else None,
               "out_gap": _gap(gj_out["poses"][:n], gt_out["poses"][:n]) if comparable else None}
        row["same_inputs"] = _same_inputs(gj_in, gj_out, trj, gt_in, gt_out, cfg, jsolve, tsolve, convert, float64)
        out["solves"].append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lockstep", action="store_true", help="step the port padded beside the JAX package")
    ap.add_argument("--scans", type=int, default=None, help="the world's first N scans (all 452 by default)")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.lockstep:
        for shared in (False, True):
            res = lockstep(args.scans, shared=shared)
            for row in res.pop("solves"):
                print(json.dumps(dict(run=res["run"], **row)), flush=True)
            print(json.dumps(res), flush=True)
        return
    from g2o_frontend_tpu.slam import line_slam as jls
    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.utils.evaluation import ate_xy

    world = _world(args.scans)
    gt = world["gt_poses"].astype(np.float64)
    odo = chip_smoke.odometry_path(gt[0], world["odom_deltas"])
    ate_odo = ate_xy(odo[:, :2], gt[:, :2])["rmse"]
    for name, drv in (("jax", jls.LineSlam2D()), ("torch_cpu", models.build("line_slam", device="cpu"))):
        merged, chi2, secs = drive(drv, world)
        st = drv.stats()
        ate = ate_xy(np.asarray(drv.poses, np.float64)[:, :2], gt[:, :2])["rmse"]
        print(json.dumps({"package": name, "scans": len(world["scans"]), "n_lines": st["n_lines"],
                          "n_obs": st["n_obs"], "merged": merged, "chi2": chi2, "ate_rmse_m": ate,
                          "ate_odometry_m": ate_odo, "seconds": secs}), flush=True)


if __name__ == "__main__":
    main()
