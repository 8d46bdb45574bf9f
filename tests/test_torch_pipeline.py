"""PyTorch port: boss serialization, the reference-format `.conf` pipelines,
pytree checkpoints, the stream processors, the non-planar 3x3 eigen
solvers, the Multi and Cylindrical projectors and the `--conf` /
`--synthetic` command lines, against the JAX package.

Tolerances:
- `load_pipeline` on g2o_frontend_tpu_torch/conf/pwn_slam_tum.conf (and on
  a copy at scale 4): every config equal to JAX's field by field, scale and
  named objects equal (exact);
- a boss file written by either package reads in the other to equal objects
  (exact, arrays and blobs included);
- `save_pytree` / `load_pytree` interchange both ways: every leaf equal
  (exact);
- `eigh3x3` / `smallest_eigenvector3x3` on random symmetric matrices:
  eigenvalues within atol 1e-5 and eigenvectors within atol 1e-4 (both are
  the same float32 closed form; observed ~1e-6);
- Multi / Cylindrical projectors: `unproject` points within atol 1e-5,
  validity equal; `project` depth within atol 1e-5 and index images equal;
- the command lines at 120x160 on the first 12 frames of eval_out/tum_seq
  with the conf at scale 4 and tests/test_torch_tracker.py's keyframe
  fraction 0.81: `pwn_slam --conf` keyframes and closures equal, final
  chi2 within rtol 0.1 (tests/test_torch_pwn_slam.py's app tolerance;
  atol 1e-9, since 12 frames close no loop and both chains solve to
  ~1e-12) and trajectories within 2e-3; `pwn_odometry --conf` and
  `--synthetic` keyframes equal, trajectories within 2e-3 and ATE within
  2e-3 m (tests/test_torch_tracker.py's tolerance).
"""
import contextlib
import dataclasses
import io
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.apps import pwn_odometry as jodo
from g2o_frontend_tpu.apps import pwn_slam as jslam
from g2o_frontend_tpu.graph import pipeline as jgp
from g2o_frontend_tpu.graph.store import PoseGraph3D as JPoseGraph3D
from g2o_frontend_tpu.io import boss as jboss
from g2o_frontend_tpu.io import checkpoint as jckpt
from g2o_frontend_tpu.io import tum as jtum
from g2o_frontend_tpu.ops import eigh3x3 as jeig
from g2o_frontend_tpu.pwn import pipeline as jpipe
from g2o_frontend_tpu.pwn import projector as jproj
from g2o_frontend_tpu.pwn.cloud import Cloud as JCloud
from g2o_frontend_tpu.pwn.merger import MergedModel as JMergedModel
from g2o_frontend_tpu.pwn.planes import PlaneSet as JPlaneSet
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.apps import pwn_odometry as todo
from g2o_frontend_tpu_torch.apps import pwn_slam as tslam
from g2o_frontend_tpu_torch.graph import pipeline as tgp
from g2o_frontend_tpu_torch.graph.store import PoseGraph3D as TPoseGraph3D
from g2o_frontend_tpu_torch.io import boss as tboss
from g2o_frontend_tpu_torch.io import checkpoint as tckpt
from g2o_frontend_tpu_torch.ops import eigh3x3 as teig
from g2o_frontend_tpu_torch.pwn import pipeline as tpipe
from g2o_frontend_tpu_torch.pwn import projector as tproj
from g2o_frontend_tpu_torch.pwn.cloud import Cloud as TCloud
from g2o_frontend_tpu_torch.pwn.merger import MergedModel as TMergedModel
from g2o_frontend_tpu_torch.pwn.planes import PlaneSet as TPlaneSet

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONF = REPO / "g2o_frontend_tpu_torch" / "conf" / "pwn_slam_tum.conf"
SEQ = REPO / "eval_out" / "tum_seq"
N_FRAMES = 12
KF_FRACTION = "0.81"  # the keyframe fraction of tests/test_torch_tracker.py


def conf_at_scale(tmp_path, scale):
    """The conf fixture with its matcher's and cache's scale set to `scale`."""
    text = CONF.read_text().replace('"scale" : 1', f'"scale" : {scale}')
    path = tmp_path / f"pwn_slam_tum_s{scale}.conf"
    path.write_text(text)
    return path


# -- configs ----------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1, 4])
def test_load_pipeline_matches_jax(tmp_path, scale):
    path = CONF if scale == 1 else conf_at_scale(tmp_path, scale)
    pj, pt = jpipe.load_pipeline(str(path)), tpipe.load_pipeline(str(path))
    for name in ("projector", "converter_config", "aligner_config", "tracker_config", "closer_config",
                 "voronoi_config"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert b is not None and type(a).__name__ == type(b).__name__, name
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name
    assert dataclasses.asdict(pt.scaled_projector()) == dataclasses.asdict(pj.scaled_projector())
    assert pt.scale == pj.scale == scale
    assert sorted(pt.extras["by_name"]) == sorted(pj.extras["by_name"]) == [
        "myCloser", "mySLAMPipeline", "myTracker", "myVoronoi"]
    # the values tests/test_boss.py asserts for the reference conf
    a, p, c = pt.aligner_config, pt.projector, pt.converter_config
    assert (a.outer_iterations, a.inner_iterations, a.inlier_max_chi2) == (10, 1, 9000)
    assert (a.inlier_distance_threshold, a.inlier_normal_angular_threshold) == (3, 0.95)
    assert (p.fx, p.cx, p.rows, p.cols) == (525, 319.5, 480, 640)
    assert (c.world_radius, c.min_image_radius, c.max_image_radius, c.min_points) == (0.1, 3, 6, 10)
    s = pt.scaled_projector()
    assert (s.rows, s.cols, s.fx) == (480 // scale, 640 // scale, 525 / scale)
    assert isinstance(pt.extras["by_name"]["mySLAMPipeline"], tgp.StreamProcessorGroup)


def test_registries_are_separate():
    """The port registers the reference class names in its own registry and
    the JAX package in its own: each resolves them to its own classes."""
    for name in ("PinholePointProjector", "PwnTracker", "ManifoldVoronoiExtractor", "StreamProcessorGroup"):
        t, j = tboss._REGISTRY[name], jboss._REGISTRY[name]
        assert t is not j and t.__module__.startswith("g2o_frontend_tpu_torch.")
        assert j.__module__.startswith("g2o_frontend_tpu.")
    assert jboss._REGISTRY["StreamProcessorGroup"] is jgp.StreamProcessorGroup


def _spec_graph(pipe, boss):
    """A small object graph of pipeline specs: pointers, a camera matrix, a
    blob-sized array and a pending 16-bit image blob."""
    proj = pipe.PinholeProjectorSpec(cameraMatrix=np.array([[500.0, 0, 160], [0, 500, 120], [0, 0, 1]]),
                                     imageRows=240, imageCols=320, transform=np.arange(200, dtype=np.float64))
    stats = pipe.StatsCalculatorSpec(worldRadius=0.2, imageMinRadius=4)
    conv = pipe.ConverterSpec(pointProjector=proj, statsCalculator=stats)
    img = np.arange(12 * 16, dtype=np.uint16).reshape(12, 16) * 97
    cache = pipe.CloudCacheSpec(converter=conv, scale=2, topic=boss.BlobRef.from_array(img))
    return pipe.MatcherSpec(converter=conv, scale=2), cache, img


def _plain(v):
    """A blob's payload, a small array flat (boss stores it as a flat
    "values" list), anything else as it is."""
    if isinstance(v, (tboss.BlobRef, jboss.BlobRef)):
        v = v.get()
    return np.ravel(v) if isinstance(v, np.ndarray) else v


def _same_specs(a, b):
    """Spec objects equal field by field."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _same_specs(x, y)
        elif isinstance(_plain(x), np.ndarray):
            np.testing.assert_array_equal(_plain(x), _plain(y), err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_boss_crosses_packages(tmp_path, direction):
    (wb, wp), (rb, rp) = ((tboss, tpipe), (jboss, jpipe))[:: 1 if direction == "port_to_jax" else -1]
    matcher, cache, img = _spec_graph(wp, wb)
    path = tmp_path / "specs.conf"
    with wb.Serializer(str(path)) as s:
        s.write(matcher)
        s.write(cache)
    back = {type(o).__name__: o for o in rb.Deserializer(str(path)).read_all()}
    mine = {type(o).__name__: o for o in wb.Deserializer(str(path)).read_all()}
    for objs in (back, mine):  # both packages read the file to the same objects
        _same_specs(objs["MatcherSpec"], matcher)
        _same_specs(objs["CloudCacheSpec"], cache)
    assert sorted(back) == sorted(mine)
    assert isinstance(back["MatcherSpec"], rp.MatcherSpec)
    assert back["CloudCacheSpec"].converter is back["MatcherSpec"].converter
    np.testing.assert_array_equal(back["CloudCacheSpec"].topic.get(), img)
    assert back["ConverterSpec"].pointProjector.build() == rp.PinholeProjectorSpec(
        cameraMatrix=matcher.converter.pointProjector.cameraMatrix, imageRows=240, imageCols=320).build()


# -- pytrees ------------------------------------------------------------------------


def _pytree_samples():
    rng = np.random.default_rng(11)
    H, W = 6, 8
    cloud = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("p", (3, H, W)), ("n", (3, H, W)), ("curv", (H, W)), ("ev", (3, H, W)), ("evec", (9, H, W)),
        ("op", (6, H, W)), ("on", (6, H, W)))}
    cloud["valid"] = rng.random((H, W)) > 0.3
    model = dict(points=rng.normal(size=(20, 3)).astype(np.float32), normals=rng.normal(size=(20, 3)).astype(np.float32),
                 weights=rng.random(20).astype(np.float32), mask=rng.random(20) > 0.5)
    planes = dict(normal=rng.normal(size=(4, 3)).astype(np.float32), d=rng.random(4).astype(np.float32),
                  n_inliers=rng.integers(0, 900, 4).astype(np.float32),
                  centroid=rng.normal(size=(4, 3)).astype(np.float32), mask=np.array([True, False, True, True]))
    graph = dict(poses=rng.normal(size=(8, 7)).astype(np.float32), pose_mask=np.arange(8) < 5,
                 pp_ij=rng.integers(0, 5, (8, 2)).astype(np.int32), pp_meas=rng.normal(size=(8, 7)).astype(np.float32),
                 pp_info=rng.normal(size=(8, 6, 6)).astype(np.float32), pp_mask=np.arange(8) < 4,
                 fixed=np.arange(8) == 0)
    return {"cloud": (cloud, JCloud, TCloud), "merged_model": (model, JMergedModel, TMergedModel),
            "plane_set": (planes, JPlaneSet, TPlaneSet), "pose_graph3d": (graph, JPoseGraph3D, TPoseGraph3D)}


def _jax_tree(arrays, cls):
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_tree(arrays, cls):
    return cls(**{k: torch.as_tensor(v if v.dtype != np.int32 else v.astype(np.int64)) for k, v in arrays.items()})


@pytest.mark.parametrize("kind", ["cloud", "merged_model", "plane_set", "pose_graph3d"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_pytree_crosses_packages(tmp_path, kind, direction):
    arrays, jcls, tcls = _pytree_samples()[kind]
    path = tmp_path / f"{kind}.npz"
    jtree, ttree = _jax_tree(arrays, jcls), _port_tree(arrays, tcls)
    if direction == "port_to_jax":
        tckpt.save_pytree(path, ttree)
        back = jckpt.load_pytree(path, jtree)
        got = {k: np.asarray(getattr(back, k)) for k in arrays}
    else:
        jckpt.save_pytree(path, jtree)
        # an example of another shape: the file decides the shapes
        example = _port_tree({k: v[:1] for k, v in arrays.items()}, tcls)
        back = tckpt.load_pytree(path, example)
        assert type(back) is tcls
        for k in arrays:
            assert getattr(back, k).dtype == getattr(example, k).dtype, k
        got = {k: getattr(back, k).numpy() for k in arrays}
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pytree_nested_containers_roundtrip(tmp_path):
    """Lists, tuples, dicts (keys sorted, as JAX flattens them) and None."""
    t = {"b": [torch.arange(3), (torch.ones(2), None)], "a": torch.zeros(2, 2, dtype=torch.bool)}
    tckpt.save_pytree(tmp_path / "t.npz", t)
    back = tckpt.load_pytree(tmp_path / "t.npz", t)
    assert back["b"][1][1] is None and isinstance(back["b"][1], tuple)
    assert torch.equal(back["b"][0], t["b"][0]) and torch.equal(back["a"], t["a"])
    leaves = np.load(tmp_path / "t.npz")
    np.testing.assert_array_equal(leaves["leaf_0"], np.zeros((2, 2), bool))  # "a" first
    j = {"b": [jnp.arange(3), (jnp.ones(2), None)], "a": jnp.zeros((2, 2), bool)}
    jback = jckpt.load_pytree(tmp_path / "t.npz", j)
    np.testing.assert_array_equal(np.asarray(jback["b"][1][0]), np.ones(2))


# -- stream processors --------------------------------------------------------------


def test_stream_processor_chain():
    double = tgp.FunctionProcessor(lambda x: x * 2, "double")
    keep_even = tgp.FunctionProcessor(lambda x: x if x % 4 == 0 else None, "even")
    sink = tgp.EnqueuerOutputHandler("sink")
    grp = tgp.chain(double, keep_even, sink)
    for k in range(6):
        grp.process(k)
    assert list(sink.queue) == [0, 4, 8]
    assert grp.node("double") is double and grp.node("nope") is None


# -- 3x3 eigen solvers --------------------------------------------------------------


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    A[0] = np.diag([1.0, 2.0, 3.0])  # axis-aligned
    A[1] = np.diag([2.0, 2.0, 5.0])  # a repeated eigenvalue
    return A


def test_eigh3x3_matches_jax():
    A = _sym(np.random.default_rng(5), 64)
    lam_t, V_t = teig.eigh3x3(torch.from_numpy(A))
    lam_j, V_j = jeig.eigh3x3(jnp.asarray(A))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(V_t.numpy(), np.asarray(V_j), atol=1e-4)
    lam_t, v_t = teig.smallest_eigenvector3x3(torch.from_numpy(A))
    lam_j, v_j = jeig.smallest_eigenvector3x3(jnp.asarray(A))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)
    # a right-handed orthonormal frame of eigenvectors
    Vt = V_t.double().numpy()
    np.testing.assert_allclose(Vt.swapaxes(1, 2) @ Vt, np.broadcast_to(np.eye(3), Vt.shape), atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(Vt), 1.0, atol=1e-4)


# -- projectors ---------------------------------------------------------------------


def _rigs():
    rng = np.random.default_rng(31)
    cyl = dict(rows=32, cols=90, min_distance=0.2, max_distance=20.0)
    cam = dict(rows=32, cols=48, fx=40.0, fy=40.0, cx=23.5, cy=15.5, min_distance=0.1, max_distance=10.0)
    T2 = np.eye(4)
    T2[0, 3], T2[2, 3] = 0.5, 0.1
    Tr = tuple(T2.reshape(-1))
    eye = tuple(np.eye(4).reshape(-1))
    jrig = jproj.MultiProjector(projectors=((jproj.PinholeProjector(**cam), eye), (jproj.PinholeProjector(**cam), Tr)))
    trig = tproj.MultiProjector(projectors=((tproj.PinholeProjector(**cam), eye), (tproj.PinholeProjector(**cam), Tr)))
    return {
        "cylindrical": (jproj.CylindricalProjector(**cyl), tproj.CylindricalProjector(**cyl),
                        rng.uniform(1.0, 8.0, (32, 90)).astype(np.float32)),
        "multi": (jrig, trig, rng.uniform(1.0, 4.0, (32, 96)).astype(np.float32)),
    }


@pytest.mark.parametrize("kind", ["cylindrical", "multi"])
def test_projectors_match_jax(kind):
    jp, tp, depth = _rigs()[kind]
    depth[3:5, 10:20] = 0.0  # a hole
    pts_j, val_j = jp.unproject(jnp.asarray(depth))
    pts_t, val_t = tp.unproject(torch.from_numpy(depth))
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-5)
    # render the JAX points, shuffled so that pixels collide, in both
    perm = np.random.default_rng(2).permutation(depth.size)
    pts = np.asarray(pts_j).reshape(-1, 3)[perm]
    val = np.asarray(val_j).reshape(-1)[perm]
    pts = np.concatenate([pts, pts * 1.3])  # farther copies lose their pixels
    val = np.concatenate([val, val])
    d_j, i_j = jp.project(jnp.asarray(pts), jnp.asarray(val))
    d_t, i_t = tp.project(torch.from_numpy(pts), torch.from_numpy(val))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert (np.asarray(i_j) >= 0).mean() > 0.5
    np.testing.assert_array_equal(tp.project_intervals(d_t, 0.1).numpy(),
                                  np.asarray(jp.project_intervals(d_j, 0.1)))


# -- command lines ------------------------------------------------------------------


def _jax_json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _trajectory(path):
    return jtum.read_trajectory(str(path))[1]


@pytest.fixture(scope="module")
def short_seq(tmp_path_factory):
    """The first N_FRAMES of eval_out/tum_seq, with its ground truth."""
    d = tmp_path_factory.mktemp("seq")
    (d / "depth").mkdir()
    lines = [ln for ln in (SEQ / "depth.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    for ln in lines[:N_FRAMES]:
        rel = ln.split()[1]
        (d / rel).write_bytes((SEQ / rel).read_bytes())
    (d / "depth.txt").write_text("\n".join(lines[:N_FRAMES]) + "\n")
    (d / "groundtruth.txt").write_bytes((SEQ / "groundtruth.txt").read_bytes())
    return d


def test_pwn_slam_conf_matches_jax(tmp_path, short_seq):
    # the conf's keyframe fraction (0.4) cuts no keyframe in 12 frames
    conf = str(conf_at_scale(tmp_path, 4))
    rt = tslam.run([str(short_seq), "--conf", conf, "--kf-fraction", KF_FRACTION, "--device", "cpu", "--out-map", str(tmp_path / "t.npz"),
                    "--out-traj", str(tmp_path / "t.txt")])
    rj = _jax_json(jslam.main, [str(short_seq), "--conf", conf, "--kf-fraction", KF_FRACTION, "--scale", "4", "--out-map", str(tmp_path / "j.npz"),
                                "--out-traj", str(tmp_path / "j.txt")])
    assert rt["frames"] == rj["frames"] == N_FRAMES
    assert (rt["keyframes"], rt["closures"]) == (rj["keyframes"], rj["closures"])
    assert rt["keyframes"] >= 3
    # without a closure the chain solves to its rounding floor (~1e-12)
    np.testing.assert_allclose(rt["final_chi2"], rj["final_chi2"], rtol=0.1, atol=1e-9)
    np.testing.assert_allclose(_trajectory(tmp_path / "t.txt")[:, :3], _trajectory(tmp_path / "j.txt")[:, :3],
                               atol=2e-3)


@pytest.mark.parametrize("mode", ["conf", "synthetic"])
def test_pwn_odometry_matches_jax(tmp_path, short_seq, mode):
    if mode == "conf":
        conf = str(conf_at_scale(tmp_path, 4))
        common_t = [str(short_seq), "--conf", conf, "--kf-fraction", KF_FRACTION]
        common_j = common_t + ["--scale", "4"]
    else:
        common_t = common_j = ["--synthetic", "--frames", "10"]
    rt = todo.run(common_t + ["--device", "cpu", "--out", str(tmp_path / "t.txt")])
    rj = _jax_json(jodo.main, common_j + ["--out", str(tmp_path / "j.txt")])
    assert rt["frames"] == rj["frames"] and rt["keyframes"] == rj["keyframes"]
    a, b = _trajectory(tmp_path / "t.txt"), _trajectory(tmp_path / "j.txt")
    np.testing.assert_allclose(a[:, :3], b[:, :3], atol=2e-3)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=2e-3)
    if mode == "conf":
        np.testing.assert_allclose(rt["ate"]["rmse"], rj["ate"]["rmse"], atol=2e-3)
    else:
        assert np.abs(a[:, :3]).max() > 0.05  # the orbit moved
