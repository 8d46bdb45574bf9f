"""PyTorch port: tracker, whole-sequence odometry, ATE, dispatch and the
no-JAX rule.

The trackers of both packages run the first 10 frames of eval_out/tum_seq at
scale 4 (120x160) with the configs of the pwn_odometry command line and a
keyframe fraction of 0.81: it cuts 4 keyframes after the first in these
frames, and every frame's inlier fraction stays >= 0.005 from it, far
beyond the packages' difference. Each package converts its own clouds, so
converter noise reaches the poses. Tolerances: per-frame inliers within 2%
(observed <= 0.1%); keyframe flags equal; trajectory within 2e-3 m and
2e-3 in the rotation entries (observed 7.5e-5). ATE of one trajectory
against JAX's float32 Horn fit: within 1e-4 m.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_frontend_tpu_torch
from g2o_frontend_tpu.io import tum
from g2o_frontend_tpu.pwn.aligner import AlignerConfig as JAlignerConfig
from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig
from g2o_frontend_tpu.pwn.projector import PinholeProjector as JPinholeProjector
from g2o_frontend_tpu.slam import pwn_tracker as jtracker
from g2o_frontend_tpu.utils import evaluation as jeval
from g2o_frontend_tpu_torch.apps import pwn_odometry
from g2o_frontend_tpu_torch.ops import fused_aligner as tfa
from g2o_frontend_tpu_torch.slam import pwn_tracker as ttracker
from g2o_frontend_tpu_torch.utils import evaluation as teval

torch.set_num_threads(1)

SEQ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "eval_out", "tum_seq")
N_FRAMES = 10
KF_FRACTION = 0.81


@pytest.fixture(scope="module")
def sequence():
    proj, ccfg, acfg = pwn_odometry.configs(4, "kinect")
    index = tum.read_depth_index(SEQ)[:N_FRAMES]
    raw = np.stack([tum.load_depth_png_raw(os.path.join(SEQ, rel))[::4, ::4] for _, rel in index])
    jproj = JPinholeProjector(**{k: getattr(proj, k) for k in proj.__dataclass_fields__})
    jccfg = JConverterConfig(min_image_radius=ccfg.min_image_radius, max_image_radius=ccfg.max_image_radius,
                             min_points=ccfg.min_points)
    min_inliers = max(50, int(3000 * (proj.rows * proj.cols) / (480 * 640)))
    return dict(proj=proj, ccfg=ccfg, acfg=acfg, jproj=jproj, jccfg=jccfg, jacfg=JAlignerConfig(outer_iterations=10),
                raw=raw, depths=raw.astype(np.float32) * np.float32(1.0 / 5000.0), min_inliers=min_inliers,
                timestamps=np.asarray([ts for ts, _ in index]))


def _assert_poses_close(a, b):
    np.testing.assert_allclose(a[:, :3, 3], b[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(a[:, :3, :3], b[:, :3, :3], atol=2e-3)


def test_tracker_matches_jax(sequence):
    s = sequence
    cfg = dict(new_frame_inliers_fraction=KF_FRACTION, min_cloud_inliers=s["min_inliers"])
    jt = jtracker.PwnTracker(s["jproj"], s["jccfg"], s["jacfg"], jtracker.PwnTrackerConfig(**cfg))
    tt = ttracker.PwnTracker(s["proj"], s["ccfg"], s["acfg"], ttracker.PwnTrackerConfig(**cfg), device="cpu")
    for d in s["depths"]:
        mj = jt.process_frame(jnp.asarray(d))
        mt = tt.process_frame(d)
        assert mt["keyframe"] == mj["keyframe"]
        assert mt["fallback"] == mj["fallback"]
        assert abs(mt["inliers"] - mj["inliers"]) <= 0.02 * max(mj["inliers"], 1)
    _assert_poses_close(tt.trajectory_array(), jt.trajectory_array())
    assert tt.n_keyframes == jt.n_keyframes == 5
    assert len(tt.manager.relations) == len(jt.manager.relations)
    assert tt.cache.recomputes == jt.cache.recomputes


def test_odometry_scan_matches_jax(sequence):
    s = sequence
    kw = dict(kf_fraction=KF_FRACTION, min_cloud_inliers=s["min_inliers"], depth_scale=1.0 / 5000.0)
    traj_j, met_j = jtracker.odometry_scan(s["raw"], s["jproj"], s["jccfg"], s["jacfg"], **kw)
    traj_t, met_t = ttracker.odometry_scan(s["raw"], s["proj"], s["ccfg"], s["acfg"], **kw, device="cpu")
    assert traj_t.shape == (N_FRAMES, 4, 4) and traj_t.dtype == torch.float32
    _assert_poses_close(traj_t.numpy(), np.asarray(traj_j))
    np.testing.assert_array_equal(met_t["keyframe"].numpy(), np.asarray(met_j["keyframe"]))
    inl_j = np.asarray(met_j["inliers"])
    assert (np.abs(met_t["inliers"].numpy() - inl_j) <= 0.02 * np.maximum(inl_j, 1)).all()
    np.testing.assert_allclose(met_t["fraction"].numpy(), np.asarray(met_j["fraction"]), atol=0.01)
    # the raw-count path equals converting on the host
    traj_f, _ = ttracker.odometry_scan(s["depths"], s["proj"], s["ccfg"], s["acfg"], kf_fraction=KF_FRACTION,
                                       min_cloud_inliers=s["min_inliers"], device="cpu")
    np.testing.assert_array_equal(traj_f.numpy(), traj_t.numpy())


def test_ate_matches_jax():
    rng = np.random.default_rng(0)
    ts_gt, gt7 = tum.read_trajectory(os.path.join(SEQ, "groundtruth.txt"))
    est7 = gt7.copy()
    a = 0.3
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    est7[:, :3] = gt7[:, :3] @ R.T + np.array([0.5, -0.2, 0.1]) + rng.normal(scale=0.02, size=(len(gt7), 3))
    rt = teval.ate(ts_gt, est7, ts_gt, gt7)
    rj = jeval.ate(ts_gt, est7, ts_gt, gt7)
    assert rt["pairs"] == rj["pairs"] == len(gt7)
    for k in ("rmse", "mean", "median", "max"):
        assert abs(rt[k] - rj[k]) < 1e-4, k
    assert 0.02 < rt["rmse"] < 0.05


def test_cli_runs_and_writes_outputs(tmp_path):
    out = tmp_path / "traj.txt"
    bench = tmp_path / "bench.txt"
    r = pwn_odometry.run([SEQ, "--device", "cpu", "--scale", "4", "--max-frames", "4", "--out", str(out),
                          "--benchmark-out", str(bench)])
    assert r["frames"] == 4 and r["ate"]["pairs"] == 4 and r["ate"]["rmse"] < 0.05
    assert len(out.read_text().splitlines()) == 4
    assert all(len(line.split()) == 14 for line in bench.read_text().splitlines())


def test_fused_system_dispatch_on_cpu(sequence):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing; on a device that is neither CPU nor CUDA it raises."""
    s = sequence
    from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud

    cloud = depth_to_cloud(torch.from_numpy(s["depths"][0]), s["proj"], s["ccfg"])
    cur, ref = tfa.pack_cur(cloud), tfa.pack_ref(cloud)
    params = tfa.params_from_invT(torch.eye(4))
    before = tfa.launches
    sums = tfa.fused_system(cur, ref, params, s["proj"], s["acfg"])
    assert tfa.launches == before
    np.testing.assert_array_equal(sums.numpy(), tfa.fused_system_reference(cur, ref, params, s["proj"], s["acfg"]).numpy())
    assert int(sums[28]) > 0.5 * s["proj"].rows * s["proj"].cols
    with pytest.raises(ValueError):
        tfa.fused_system(cur.to("meta"), ref.to("meta"), params.to("meta"), s["proj"], s["acfg"])


def test_tf32_off_and_no_jax_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    pkg = os.path.dirname(g2o_frontend_tpu_torch.__file__)
    modules = sorted(
        "g2o_frontend_tpu_torch." + os.path.relpath(os.path.join(root, f), pkg)[:-3].replace(os.sep, ".")
        for root, _, files in os.walk(pkg)
        for f in files
        if f.endswith(".py") and f != "__init__.py"
    )
    assert len(modules) >= 14
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if k.startswith('jax'))\n"
        "print('ok')\n"
    )
    root = os.path.dirname(pkg)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
