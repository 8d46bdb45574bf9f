"""The JAX package's line SLAM over phase 14 (b)'s laser world, the
reference count that `chip_smoke.py` holds the port's card run against.

Runs `g2o_frontend_tpu.slam.line_slam.LineSlam2D` (JAX, on the CPU) and
the port's `LineSlam2D` on the CPU over the same 452 simulated scans
(`chip_smoke.GRID_WORLD`), each followed by `merge_landmarks` and one
final `optimize`, as `chip_smoke.cpu_slice5` drives the port. Prints one
JSON line per package: lines, observations, ATE rmse (m) against the
ground truth and the odometry's, and the seconds taken.

    JAX_PLATFORMS=cpu python tools/jax_line_slam_reference.py

Needs JAX, so it runs beside the tests, never on the machine with the
card.
"""
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


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from g2o_frontend_tpu.slam import line_slam as jls
    from g2o_frontend_tpu_torch import models
    from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world
    from g2o_frontend_tpu_torch.utils.evaluation import ate_xy

    world = simulate_laser_world(LaserWorldConfig(**chip_smoke.GRID_WORLD))
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
