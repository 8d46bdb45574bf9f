"""PyTorch port: the graph_optimizer command line against the JAX app,
`convert.pose_graph2d_from_numpy` / `pose_graph2d_to_numpy`, and
`graph3d_from_log` on a log with EDGE_SE3_PRIOR records.

Inputs: a `write_g2o` file of the default `simulate()` world (200 poses, 80
landmarks) and of the SE3 world of tests/test_torch_pose_graph.py (40
poses). Both apps run on the CPU (the port's with ``--device cpu``) at
their defaults (15 LM iterations, 100 CG iterations), and on the SE2 file
once more with ``--devices 2`` (edges sharded: the port's stacked mesh,
JAX's virtual CPU mesh).

Tolerances: `chi2_initial` and `chi2_final` within rtol 1e-3 of the JAX
app's; the written vertices within atol 1e-4; every other record of the
written files equal.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from g2o_frontend_tpu.apps import graph_optimizer as japp
from g2o_frontend_tpu.graph.store import graph2d_from_log as jgraph2d_from_log
from g2o_frontend_tpu.slam.simulator import SimulatorConfig, simulate
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.apps import graph_optimizer as tapp
from g2o_frontend_tpu_torch.io.g2o import read_g2o, write_g2o
from tests.test_torch_g2o_io import _se3_log

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    out = {"se2": d / "world.g2o", "se3": d / "se3.g2o"}
    write_g2o(out["se2"], simulate(SimulatorConfig()).to_g2o_log())
    write_g2o(out["se3"], _se3_log())
    return out


@pytest.mark.parametrize("kind", ["se2", "se3"])
def test_graph_optimizer_matches_jax(files, kind, tmp_path):
    rt = tapp.run([str(files[kind]), "-o", str(tmp_path / "t.g2o"), "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert japp.main([str(files[kind]), "-o", str(tmp_path / "j.g2o")]) == 0
    rj = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rt["dim"] == rj["dim"] == (2 if kind == "se2" else 3)
    for key in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-3)
    assert rt["chi2_final"] < 0.1 * rt["chi2_initial"]
    lt, lj = read_g2o(tmp_path / "t.g2o"), read_g2o(tmp_path / "j.g2o")
    for name in ("se2_poses", "xy_points", "se3_poses"):
        np.testing.assert_allclose(getattr(lt, name), getattr(lj, name), atol=1e-4, err_msg=name)
    for name in ("se2_ids", "xy_ids", "se3_ids", "edge_se2_ij", "edge_se2_meas", "edge_se2xy_ij", "edge_se3_ij",
                 "edge_se3_meas", "fixed_ids"):
        np.testing.assert_array_equal(getattr(lt, name), getattr(lj, name), err_msg=name)


def test_graph_optimizer_prints_json_and_refuses_devices(files, tmp_path, capsys):
    """One JSON line with the JAX app's keys; ``--devices 2`` no longer
    refuses: the edges are sharded over a stacked mesh of 2, held against
    the JAX app's ``--devices 2`` on its virtual mesh (the tolerances of
    `test_graph_optimizer_matches_jax`)."""
    assert tapp.main([str(files["se2"]), "-o", str(tmp_path / "o.g2o"), "--device", "cpu", "--iters", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"dim", "chi2_initial", "chi2_final", "output"}
    rt = tapp.run([str(files["se2"]), "-o", str(tmp_path / "t.g2o"), "--devices", "2", "--device", "cpu"])
    assert japp.main([str(files["se2"]), "-o", str(tmp_path / "j.g2o"), "--devices", "2"]) == 0
    rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("chi2_initial", "chi2_final"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-3)
    assert rt["chi2_final"] < 0.1 * rt["chi2_initial"]
    lt, lj = read_g2o(tmp_path / "t.g2o"), read_g2o(tmp_path / "j.g2o")
    for name in ("se2_poses", "xy_points"):
        np.testing.assert_allclose(getattr(lt, name), getattr(lj, name), atol=1e-4, err_msg=name)


def test_pose_graph2d_crosses_through_numpy():
    gj, _ = jgraph2d_from_log(simulate(SimulatorConfig(n_poses=20, n_landmarks=4)).to_g2o_log())
    arrays = {name: np.asarray(getattr(gj, name)) for name in gj.__dataclass_fields__}
    g = convert.pose_graph2d_from_numpy(arrays, device="cpu")
    assert g.pp_ij.dtype == g.pl_ij.dtype == torch.int64 and g.fixed.dtype == g.pl_mask.dtype == torch.bool
    assert g.poses.dtype == torch.float32 and g.n_poses == 20 and g.n_landmarks == 4
    back = convert.pose_graph2d_to_numpy(g)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)


def test_graph3d_from_log_with_prior_anchor_matches_jax(tmp_path):
    """An SE3 log with EDGE_SE3_PRIOR records (`boss_tools add-imu
    --synthesize`): the priors become edges from one fixed identity anchor
    appended after the poses, in both packages; equal on JAX's unpadded
    prefix, chi2 within rtol 1e-5."""
    from g2o_frontend_tpu.graph.store import graph3d_from_log as jgraph3d_from_log
    from g2o_frontend_tpu.solvers import pose_graph as jpg
    from g2o_frontend_tpu_torch.apps import boss_tools
    from g2o_frontend_tpu_torch.graph.store import graph3d_from_log
    from g2o_frontend_tpu_torch.solvers import pose_graph as tpg

    write_g2o(tmp_path / "se3.g2o", _se3_log())
    with contextlib.redirect_stdout(io.StringIO()):
        boss_tools.main(["add-imu", str(tmp_path / "se3.g2o"), "-o", str(tmp_path / "imu.g2o"), "--synthesize"])
    log = read_g2o(tmp_path / "imu.g2o")
    gt, maps = graph3d_from_log(log, device="cpu")
    gj, _ = jgraph3d_from_log(log)
    n, e = len(log.se3_ids) + 1, len(log.edge_se3_ij) + len(log.prior_se3_ids)
    assert gt.poses.shape == (n, 7) and gt.pp_ij.shape == (e, 2) and len(maps["pose_id2idx"]) == n - 1
    assert bool(gt.fixed[n - 1]) and (gt.pp_ij[len(log.edge_se3_ij):, 0] == n - 1).all()
    for name, k in (("poses", n), ("pose_mask", n), ("fixed", n), ("pp_ij", e), ("pp_meas", e), ("pp_info", e),
                    ("pp_mask", e)):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name))[:k], err_msg=name)
    np.testing.assert_allclose(float(tpg.chi2_se3(gt)), float(jpg.chi2_se3(gj)), rtol=1e-5)
