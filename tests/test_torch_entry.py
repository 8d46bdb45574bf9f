"""PyTorch port: the system's entry points (`entry.py`, `apps/bench.py`)
against the JAX package's (`__graft_entry__.py`, `bench.py`) on the CPU.

- `entry()`: the port's step on the CPU against `__graft_entry__.entry()`
  on the same 120x160 pair: T within 5e-4 m and 1e-4 rad (observed 2.2e-4
  m along y, which the pair's surface, constant down each column, barely
  constrains: its information is 1.9e4 against 3e6-3e7 on the other axes;
  2.0e-5 rad), inliers within 0.5% (observed 0.11%), omega within 1e-2 of
  its largest entry (observed 2.7e-3). The two converters' integral images
  differ (the CPU's `torch.cumsum` accumulates float32 in float64, XLA's in
  float32); on the JAX package's own clouds the port's align agrees within
  1e-6 m and rad (observed 2.2e-7 and 1.2e-8), inliers equal, omega within
  1e-5 (observed 2.6e-7).
- `dryrun_multichip(4, device="cpu")`, step by step, against the JAX
  function the JAX dry run calls, on the conftest's virtual CPU mesh of 4
  devices, with the port's graphs handed to JAX at their exact counts (as
  tests/test_torch_parallel.py does). The dry run's graphs equal the JAX
  dry run's. Traces within rtol 1e-5 (the 2-LM and 1-LM steps; observed
  <= 3e-7), 1e-4 for the 20-LM Schur and SE3 SPIKE runs (observed <= 4e-6);
  the Schur LM count equal, its CG count within 5% (CG stops on its
  tolerance: the count moves with rounding); the partition stats and the
  SE3 float64 control equal.
- the bench's pair (`utils/synth.bench_pair` at 640x480 and 120x160)
  against `bench.py`'s `_make_depth_pair` (taken from the file with `ast`:
  importing `bench.py` would turn on JAX's persistent compilation cache):
  the same projector and pose, depths within 1e-6 relative.
- `bench_align_and_tracker` (what `bench.run` times) at 120x160 on the
  CPU, with few repetitions and on the process's CPU clock: the aligner
  recovers the pair's motion within 1 cm and a tracker frame (a conversion
  plus an align) is slower than a bare align, as `bench.run` asserts on
  the card; `bench_pwn_aligner` and `bench_tracker` alone give finite
  rates and the same accuracy.
"""
import ast
import contextlib
import dataclasses
import io
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
from g2o_frontend_tpu.graph.store import PoseGraph2D as JPoseGraph2D
from g2o_frontend_tpu.parallel import mesh as jmesh
from g2o_frontend_tpu.parallel import partitioned_pose_graph as jpp
from g2o_frontend_tpu.parallel import partitioned_schur as jps
from g2o_frontend_tpu.parallel import sharded_ba as jsba
from g2o_frontend_tpu.parallel import sharded_pose_graph as jsp
from g2o_frontend_tpu.slam.simulator import Simulator3DConfig, simulate_se3
from g2o_frontend_tpu.solvers import ba as jba
from g2o_frontend_tpu.solvers import pose_graph as jpg
from g2o_frontend_tpu.solvers.control import control_optimize_se3
from g2o_frontend_tpu_torch import entry
from g2o_frontend_tpu_torch.apps import bench
from g2o_frontend_tpu_torch.utils import synth
from tests.test_torch_parallel import _jax_fields

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 4


# -- entry() ---------------------------------------------------------------------


def _tensors(arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def test_entry_matches_jax():
    """The whole step, and the port's align on the JAX package's clouds."""
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.shape == (120, 160) and a.dtype == torch.float32 for a in args)
    jfn, jargs = ge.entry()
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    chip_smoke.entry_close("the whole step against JAX", fn(*args), _tensors(jax.jit(jfn)(*jargs)),
                           dict(t_m=5e-4, r_rad=1e-4, inliers=0.005, omega_rtol=1e-2))

    from g2o_frontend_tpu.pwn.aligner import AlignerConfig as JAlignerConfig, align as jalign
    from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig, depth_to_cloud as jdepth_to_cloud
    from g2o_frontend_tpu.pwn.projector import PinholeProjector as JPinholeProjector
    from g2o_frontend_tpu_torch.pwn.aligner import AlignerConfig, align
    from g2o_frontend_tpu_torch.pwn.cloud import Cloud
    from g2o_frontend_tpu_torch.pwn.projector import PinholeProjector

    cam = dict(rows=120, cols=160, fx=131.25, fy=131.25, cx=79.5, cy=59.5, min_distance=0.1, max_distance=10.0)
    ccfg = JConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    jref, jcur = (jdepth_to_cloud(d, JPinholeProjector(**cam), ccfg) for d in jargs)
    rj = jalign(jref, jcur, JPinholeProjector(**cam), config=JAlignerConfig(outer_iterations=5))
    ref, cur = (Cloud(*(torch.tensor(np.asarray(f)) for f in c)) for c in (jref, jcur))
    rt = align(ref, cur, PinholeProjector(**cam), config=AlignerConfig(outer_iterations=5))
    chip_smoke.entry_close("align on JAX's clouds", (rt.T, rt.omega, rt.inliers), _tensors((rj.T, rj.omega, rj.inliers)),
                           dict(t_m=1e-6, r_rad=1e-6, inliers=0.0, omega_rtol=1e-5))


# -- dryrun_multichip --------------------------------------------------------------


@pytest.fixture(scope="module")
def dryrun_run():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = entry.dryrun_multichip(N_DEV, device="cpu")
    return out, buf.getvalue()


@pytest.fixture
def dryrun(dryrun_run):
    return dryrun_run[0]


def test_dryrun_prints_the_summary_line(dryrun_run):
    lines = dryrun_run[1].strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(f"dryrun_multichip OK on {N_DEV} devices; pose-graph chi2=")
    for key in ("BA chi2=", "partitioned victoriaPark chi2=", "distributed-Schur chi2=", "SE3-sim SPIKE chi2="):
        assert key in lines[0]


@pytest.mark.parametrize("n,n_loop", [(32, 4), (256, 16)])
def test_small_graph_matches_jax(n, n_loop):
    """The port packs exact counts, JAX pads to powers of two: prefixes."""
    g, gj = entry._small_graph(n, n_loop, device="cpu"), ge._small_graph(n, n_loop)
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name).numpy(), np.asarray(getattr(gj, f.name))
        np.testing.assert_allclose(a, b[: len(a)], rtol=1e-6, err_msg=f.name)
        assert not b[len(a):].any() or f.name.endswith(("_info", "_meas", "poses", "landmarks")), f.name
    assert g.n_poses == n and int(g.pp_mask.sum()) == n - 1 + n_loop


def _jax_graph(n, n_loop):
    return JPoseGraph2D(**_jax_fields(entry._small_graph(n, n_loop, device="cpu")))


def test_dryrun_sharded_se2_matches_jax(dryrun):
    _, trj = jsp.optimize_se2_sharded(_jax_graph(32, 4), jmesh.make_mesh(N_DEV), iters=1, cg_iters=10)
    np.testing.assert_allclose(dryrun["sharded_se2"].numpy(), np.asarray(trj), rtol=1e-5)


def test_dryrun_partitioned_matches_jax(dryrun):
    gj = _jax_graph(256, 16)
    _, st = jpg.optimize_se2(gj, iters=2, cg_iters=40)
    np.testing.assert_allclose(dryrun["single_device"].numpy(), np.asarray(st.chi2), rtol=1e-5)
    _, trj, stj = jpp.optimize_se2_partitioned(gj, jmesh.make_mesh(N_DEV), iters=2, cg_iters=40)
    np.testing.assert_allclose(dryrun["partitioned_jacobi"].numpy(), np.asarray(trj), rtol=1e-5)
    assert dryrun["partition"] == stj["partition"]
    _, trc, _ = jpp.optimize_se2_partitioned(gj, jmesh.make_mesh(N_DEV), iters=2, cg_iters=40, precond="chain")
    np.testing.assert_allclose(dryrun["partitioned_chain"].numpy(), np.asarray(trc), rtol=1e-5)


def test_dryrun_schur_matches_jax(dryrun):
    _, trj, stj = jps.optimize_se2_schur_partitioned(_jax_graph(256, 16), jmesh.make_mesh(N_DEV), iters=20,
                                                     cg_iters=40)
    np.testing.assert_allclose(dryrun["schur"].numpy(), np.asarray(trj), rtol=1e-4)
    st = dryrun["schur_stats"]
    assert st["lm_iters"] == stj["lm_iters"]
    assert abs(st["cg_total"] - stj["cg_total"]) <= 0.05 * stj["cg_total"], (st["cg_total"], stj["cg_total"])


def test_dryrun_se3_spike_matches_jax(dryrun):
    gj, _ = simulate_se3(Simulator3DConfig(**entry.DRYRUN_SE3_WORLD))
    assert dryrun["se3_control"] == control_optimize_se3(gj, max_iters=40)["chi2"]
    with jax.default_matmul_precision("highest"):
        _, trj = jpp.optimize_se3_partitioned(gj, jmesh.make_mesh(N_DEV), iters=20, cg_iters=80, precond="spike")
    np.testing.assert_allclose(dryrun["se3_spike"].numpy(), np.asarray(trj), rtol=1e-4)


def test_dryrun_ba_matches_jax(dryrun):
    """The port's problem equals the one the JAX dry run builds within
    1e-6; the solve is held on the port's problem, its trace within rtol
    1e-5 or 1e-8 absolute: it falls from 68.6 to ~9.3e-7 (observed 1.5e-9
    apart there)."""
    bt = entry._ba_dryrun_problem("cpu")
    rng = np.random.default_rng(1)
    rng.uniform(-2, 2, (24, 3))
    from g2o_frontend_tpu.utils import lie as jlie

    for k in range(4):
        xi = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.2, 0.2, 3)])
        T = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
        q = np.asarray(jlie.mat2quat_full(jnp.asarray(T[:3, :3], jnp.float32)))
        np.testing.assert_allclose(bt.poses[k].numpy(), np.concatenate([T[:3, 3], q[1:], q[:1]]), atol=1e-6)
    with jax.default_matmul_precision("highest"):
        _, trj = jsba.optimize_ba_sharded(jba.BAProblem(**_jax_fields(bt)), jmesh.make_mesh(N_DEV), iters=1,
                                          cg_iters=10)
    np.testing.assert_allclose(dryrun["ba"].numpy(), np.asarray(trj), rtol=1e-5, atol=1e-8)


# -- the bench ---------------------------------------------------------------------


def _bench_py(*names):
    """Functions of bench.py by name, executed without its module body."""
    path = os.path.join(REPO, "bench.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return [ns[n] for n in names]


@pytest.mark.parametrize("H,W", [(480, 640), (120, 160)])
def test_bench_pair_matches_make_depth_pair(H, W):
    (make,) = _bench_py("_make_depth_pair")
    d_ref, d_cur, proj, T_gt = synth.bench_pair("cpu", H, W)
    jd_ref, jd_cur, jproj, jT = make(H, W)
    assert (proj.rows, proj.cols, proj.fx, proj.fy, proj.cx, proj.cy, proj.min_distance, proj.max_distance) == (
        jproj.rows, jproj.cols, jproj.fx, jproj.fy, jproj.cx, jproj.cy, jproj.min_distance, jproj.max_distance)
    np.testing.assert_allclose(T_gt, jT, atol=1e-6)
    np.testing.assert_array_equal(d_ref.numpy(), np.asarray(jd_ref))
    np.testing.assert_allclose(d_cur.numpy(), np.asarray(jd_cur), rtol=1e-6)


def test_bench_aligner_and_tracker_on_the_cpu(monkeypatch):
    """Timed on the process's CPU clock: on the wall clock of a host shared
    with the suite's other workers the two rates, 10-20% apart, swap
    places (3 runs of 4 did)."""
    monkeypatch.setattr(bench, "time", types.SimpleNamespace(perf_counter=time.process_time))
    r = bench.bench_align_and_tracker("cpu", 120, 160, reps=2, lo=2, hi=10, tries=3)
    assert r["t_err_m"] < 0.01 and r["inliers"] > 0
    assert all(np.isfinite(r[k]) and r[k] > 0 for k in ("align_fps", "convert_fps", "tracker_fps"))
    assert r["tracker_fps"] < r["align_fps"], r


def test_bench_sections_alone_on_the_cpu():
    """The JAX bench's two functions, each timed alone (few, short chains:
    rates only finite and positive; the accuracy as in the turns above)."""
    pwn = bench.bench_pwn_aligner("cpu", 120, 160, reps=1)
    trk = bench.bench_tracker(120, 160, lo=1, hi=3, device="cpu")
    assert pwn["t_err_m"] < 0.01 and pwn["inliers"] > 0
    assert all(np.isfinite(v) and v > 0 for v in (pwn["align_fps"], pwn["convert_fps"], trk["tracker_fps"]))
