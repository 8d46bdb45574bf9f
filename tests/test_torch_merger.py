"""PyTorch port: voxel downsampling, the cloud merger, the map merger's cloud
fusion, `.pwn` cloud files and the cloud_aligner command line, against the
JAX package.

Both packages run on the CPU and, apart from the command line, see the same
clouds: the JAX converter's, carried into the port by `convert`.

Tolerances:
- `voxelize`: occupancy and counts exact, centroids within rtol 1e-6
  (atol 1e-7), also with a table small enough that voxels collide;
- `add_cloud`: masks and weights exact, points and normals within rtol 1e-6;
- `collapse`: masks exact, points and weights within rtol 1e-5, on the JAX
  test's duplicated cloud (tests/test_sensors_merger_sim.py), on two views
  of the room and viewed through a transform;
- the map merger's cloud fusion: the survivor's cached depth within atol
  1e-5 of the JAX building blocks called as intended (``collapse(...,
  config=MergerConfig())``, ``project(fused.points, fused.mask)``), and
  changed; JAX's own `MapMerger(cloud_cache=...)` leaves it unchanged;
- `.pwn` files written by the two packages are byte-equal (binary and
  ASCII); `load_pwn` equal; `cloud_from_pwn` within rtol 1e-6 (atol 1e-6);
- cloud_aligner on two TUM frames at 120x160 (depth PNGs, and the same
  frames as `.pwn` files) with the JAX converter's clouds in both:
  tests/test_torch_aligner.py's end-to-end tolerances, T within rtol 1e-4
  and atol 1e-5, inliers within 2, chi2 within rtol 1e-3, valid equal;
  with each package's own clouds, tests/test_torch_tracker.py's 2e-3 on T
  and inliers within 1%.
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

from g2o_frontend_tpu.apps import cloud_aligner as japp
from g2o_frontend_tpu.graph import map_manager as jmm
from g2o_frontend_tpu.pwn import cloud_io as jio
from g2o_frontend_tpu.pwn import merger as jm
from g2o_frontend_tpu.pwn import projector as jproj
from g2o_frontend_tpu.pwn import voxel as jvox
from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig
from g2o_frontend_tpu.pwn.converter import depth_to_cloud as jdepth_to_cloud
from g2o_frontend_tpu.slam import map_merger as jmerge
from g2o_frontend_tpu.slam.pwn_tracker import CloudCache as JCloudCache
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.apps import cloud_aligner as tapp
from g2o_frontend_tpu_torch.graph import map_manager as tmm
from g2o_frontend_tpu_torch.pwn import cloud_io as tio
from g2o_frontend_tpu_torch.pwn import merger as tm
from g2o_frontend_tpu_torch.pwn import voxel as tvox
from g2o_frontend_tpu_torch.slam import map_merger as tmerge
from g2o_frontend_tpu_torch.slam import pwn_tracker as tpwn_tracker

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEQ = REPO / "eval_out" / "tum_seq"
PROJ = default_projector(H=96, W=128)
JCCFG = JConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
TPROJ = convert.config_from(PROJ)


def pose(xi):
    return np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)


def jcloud(T=np.eye(4)):
    return jdepth_to_cloud(jnp.asarray(render_planes_depth(T, PROJ)), PROJ, JCCFG)


def to_port(jc):
    return convert.cloud_from_numpy({k: np.asarray(v) for k, v in jc._asdict().items()}, device="cpu")


def port_model(jmodel):
    return convert.merged_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu")


def assert_models_match(tmodel, jmodel, rtol):
    np.testing.assert_array_equal(tmodel.mask.numpy(), np.asarray(jmodel.mask))
    for name in ("points", "normals", "weights"):
        np.testing.assert_allclose(getattr(tmodel, name).numpy(), np.asarray(getattr(jmodel, name)), rtol=rtol,
                                   atol=rtol, err_msg=name)


# -- voxels ---------------------------------------------------------------------------


@pytest.mark.parametrize("resolution,table_size", [(0.02, 1 << 16), (0.1, 1 << 16), (0.05, 1 << 8)])
def test_voxelize_matches_jax(resolution, table_size):
    jc = jcloud(pose([0.1, -0.05, 0.2, 0.02, 0.1, 0.0]))
    pts = np.asarray(jc.points).reshape(-1, 3) - 1.0  # negative keys too
    valid = np.asarray(jc.valid).reshape(-1)
    cj, nj, oj = jvox.voxelize(jnp.asarray(pts), jnp.asarray(valid), resolution, table_size)
    ct, nt, ot = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(valid), resolution, table_size)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-7)
    assert 10 < int(ot.sum()) < int(valid.sum())
    n_voxels = len(np.unique(np.floor(pts[valid] / np.float32(resolution)).astype(np.int32), axis=0))
    if table_size == 1 << 8:  # more voxels than slots: they collide
        assert n_voxels > table_size
    down = tvox.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid), resolution, table_size)
    np.testing.assert_allclose(down.numpy(), jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), resolution,
                                                                   table_size), rtol=1e-6, atol=1e-7)


def test_voxel_hash_stays_int32():
    """The hash wraps around in int32, as JAX's does: keys far from the
    origin overflow the products."""
    pts = np.array([[1e3, -2e3, 3e3], [-4e3, 5e3, 6e3], [0.01, 0.02, 0.03]], np.float32)
    ok = np.ones(3, bool)
    _, nt, _ = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(ok), 0.01, 1 << 16)
    _, nj, _ = jvox.voxelize(jnp.asarray(pts), jnp.asarray(ok), 0.01, 1 << 16)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


# -- the cloud merger -------------------------------------------------------------------


def test_add_cloud_matches_jax():
    rng = np.random.default_rng(3)
    jc = jcloud()
    X = pose([0.03, 0.0, -0.02, 0.0, 0.05, 0.0])
    C = 20000  # fewer slots than the two clouds' points: the second overflows
    occupied = rng.random(C) < 0.2
    start = jm.MergedModel(points=jnp.asarray(rng.normal(size=(C, 3)), jnp.float32),
                           normals=jnp.zeros((C, 3), jnp.float32), weights=jnp.asarray(occupied, jnp.float32) * 3,
                           mask=jnp.asarray(occupied))
    mj = jm.add_cloud(jm.add_cloud(start, jc), jc, jnp.asarray(X, jnp.float32))
    tc = to_port(jc)
    mt = tm.add_cloud(tm.add_cloud(port_model(start), tc), tc, torch.as_tensor(X, dtype=torch.float32))
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_array_equal(mt.weights.numpy(), np.asarray(mj.weights))
    np.testing.assert_allclose(mt.points.numpy(), np.asarray(mj.points), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mt.normals.numpy(), np.asarray(mj.normals), rtol=1e-6, atol=1e-6)
    assert bool(mt.mask.all())


def _collapse_case(case):
    """(JAX model, transform or None, MergerConfig kwargs) of a case."""
    jc = jcloud()
    if case == "duplicate":  # tests/test_sensors_merger_sim.py's fixture
        model = jm.add_cloud(jm.add_cloud(jm.empty_model(65536), jc), jc)
        return model, None, dict(distance_threshold=0.05)
    X = pose([0.02, -0.01, 0.03, 0.0, 0.04, 0.01])  # a second view, 3.7 cm away
    model = jm.add_cloud(jm.add_cloud(jm.empty_model(2 * 96 * 128), jc), jcloud(X), jnp.asarray(X, jnp.float32))
    if case == "two_views":
        return model, None, {}
    return model, pose([0.0, 0.02, -0.05, 0.03, 0.0, 0.0]), dict(normal_threshold=0.9)


@pytest.mark.parametrize("case", ["duplicate", "two_views", "through_transform"])
def test_collapse_matches_jax(case):
    jmodel, T, kw = _collapse_case(case)
    jT = None if T is None else jnp.asarray(T, jnp.float32)
    tT = None if T is None else torch.as_tensor(T, dtype=torch.float32)
    fj = jm.collapse(jmodel, PROJ, jT, config=jm.MergerConfig(**kw))
    ft = tm.collapse(port_model(jmodel), TPROJ, tT, config=tm.MergerConfig(**kw))
    assert_models_match(ft, fj, rtol=1e-5)
    n_before, n_after = jmodel.n_points(), ft.n_points()
    assert n_after < 0.8 * n_before, (n_before, n_after)
    if case == "duplicate":  # survivors of duplicated regions carry weight 2
        w = ft.weights[ft.mask]
        assert int((w >= 2.0 - 1e-6).sum()) > 0.5 * n_after


# -- the map merger's cloud fusion ------------------------------------------------------


def _revisit_map(mm):
    """Two keyframes of one place, 3 cm apart, joined by an accepted closure."""
    mgr = mm.MapManager()
    X = pose([0.02, -0.01, 0.02, 0.0, 0.03, 0.0])
    a = mgr.add_node(np.eye(4), payload={"frame": 0})
    b = mgr.add_node(X, payload={"frame": 1})
    mgr.add_relation(mm.MapRelation(a, b, X, np.eye(6)))
    mgr.add_relation(mm.MapRelation(b, a, np.linalg.inv(X), np.eye(6), is_closure=True, accepted=True))
    return mgr, X


def _jax_cloud_converter(depth, projector, ccfg):
    """The JAX converter in the port's cloud cache: both caches then hold the
    same clouds."""
    return to_port(jdepth_to_cloud(jnp.asarray(depth.numpy()), PROJ, JCCFG))


@pytest.fixture
def fusion(monkeypatch):
    monkeypatch.setattr(tpwn_tracker, "depth_to_cloud", _jax_cloud_converter)
    mgr_t, X = _revisit_map(tmm)
    depths = [np.asarray(render_planes_depth(T, PROJ)) for T in (np.eye(4), X)]
    cache_t = tpwn_tracker.CloudCache(TPROJ, convert.config_from(JCCFG))
    cache_j = JCloudCache(PROJ, JCCFG)
    for k, d in enumerate(depths):
        cache_t.put(k, torch.from_numpy(d))
        cache_j.put(k, d)
    return mgr_t, cache_t, cache_j, depths, X


def test_fuse_clouds_matches_jax_building_blocks(fusion):
    mgr_t, cache_t, cache_j, depths, X = fusion
    merger = tmerge.MapMerger(mgr_t, cloud_cache=cache_t)
    assert merger.collapse_redundant() == 1 and merger.merged_pairs == [(0, 1)]
    fused_t = cache_t._depths[0]
    # the JAX building blocks, called as the JAX docstring intends
    keep_c, drop_c = cache_j.get(0), cache_j.get(1)
    model = jm.empty_model(2 * 96 * 128)
    model = jm.add_cloud(jm.add_cloud(model, keep_c), drop_c, jnp.asarray(X, jnp.float32))
    fused = jm.collapse(model, PROJ, config=jm.MergerConfig())
    depth_j, _ = PROJ.project(fused.points, fused.mask)
    np.testing.assert_allclose(fused_t.numpy(), np.asarray(depth_j), atol=1e-5)
    changed = np.abs(fused_t.numpy() - depths[0]) > 1e-6
    assert changed.sum() > 100, changed.sum()  # the survivor's depth changed
    # the cache derives the survivor's cloud from the fused depth anew
    assert torch.equal(cache_t.get(0).p, tpwn_tracker.depth_to_cloud(fused_t, TPROJ, None).p)


def test_jax_fuse_clouds_leaves_depth_unchanged(fusion):
    """The fault in the JAX merger: its `_fuse_clouds` passes MergerConfig()
    as `collapse`'s transform and reads `fused.valid`; a bare `except`
    swallows both, and the survivor's cached depth stays as it was."""
    _, _, cache_j, depths, _ = fusion
    mgr_j, _ = _revisit_map(jmm)
    merger = jmerge.MapMerger(mgr_j, cloud_cache=cache_j)
    assert merger.collapse_redundant() == 1
    np.testing.assert_array_equal(cache_j._depths[0], depths[0])


def test_fuse_clouds_raises_on_failure(fusion):
    """A fusion that fails raises: the port has no bare `except`."""
    mgr_t, cache_t, _, _, _ = fusion
    cache_t.projector = None
    with pytest.raises(AttributeError):
        tmerge.MapMerger(mgr_t, cloud_cache=cache_t).collapse_redundant()


# -- .pwn files ---------------------------------------------------------------------------


@pytest.mark.parametrize("binary,step", [(True, 1), (False, 3)])
def test_pwn_files_byte_equal(tmp_path, binary, step):
    jc = jcloud(pose([0.05, 0.0, 0.1, 0.0, 0.1, 0.0]))
    T = pose([0.1, -0.2, 0.3, 0.05, -0.02, 0.2])
    jio.save_pwn(tmp_path / "j.pwn", jc, T=T, step=step, binary=binary)
    tio.save_pwn(tmp_path / "t.pwn", to_port(jc), T=T, step=step, binary=binary)
    assert (tmp_path / "t.pwn").read_bytes() == (tmp_path / "j.pwn").read_bytes()
    dj, dt = jio.load_pwn(tmp_path / "j.pwn"), tio.load_pwn(tmp_path / "j.pwn")
    assert sorted(dt) == sorted(dj)
    for k in dj:
        np.testing.assert_array_equal(dt[k], np.asarray(dj[k]), err_msg=k)
    cj = jio.cloud_from_pwn(tmp_path / "j.pwn", JCCFG)
    ct = tio.cloud_from_pwn(tmp_path / "t.pwn", convert.config_from(JCCFG), device="cpu")
    for k, v in convert.cloud_to_numpy(ct).items():
        np.testing.assert_allclose(v, np.asarray(getattr(cj, k)), rtol=1e-6, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        (tmp_path / "bad.pwn").write_bytes(b"NOTPWN 1 1\n")
        tio.load_pwn(tmp_path / "bad.pwn")


def test_convert_plane_set_and_merged_model():
    rng = np.random.default_rng(1)
    arrays = dict(normal=rng.normal(size=(4, 3)), d=rng.random(4), n_inliers=np.arange(4.0),
                  centroid=rng.normal(size=(4, 3)), mask=np.array([1, 0, 1, 1]))
    ps = convert.plane_set_from_numpy(arrays, device="cpu")
    assert ps.mask.dtype == torch.bool and ps.normal.dtype == torch.float32
    np.testing.assert_array_equal(ps.mask.numpy(), arrays["mask"].astype(bool))
    jmodel, _, _ = _collapse_case("duplicate")
    tmodel = port_model(jmodel)
    assert tmodel.mask.dtype == torch.bool and tmodel.n_points() == jmodel.n_points()


# -- cloud_aligner ------------------------------------------------------------------------


def _frames(tmp_path, kind):
    lines = [ln.split()[1] for ln in (SEQ / "depth.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    pngs = [str(SEQ / lines[0]), str(SEQ / lines[3])]
    if kind == "png":
        return pngs, ["--scale", "4"]
    # the same frames as .pwn clouds, re-rendered by the command lines at 120x160
    from g2o_frontend_tpu.io.tum import load_depth_png
    from g2o_frontend_tpu.pwn.projector import PinholeProjector

    proj = PinholeProjector(rows=120, cols=160, fx=525 / 4, fy=525 / 4, cx=319.5 / 4, cy=239.5 / 4,
                            min_distance=0.1, max_distance=10.0)
    paths = []
    for k, png in enumerate(pngs):
        d = jnp.asarray(load_depth_png(png)[::4, ::4])
        paths.append(str(tmp_path / f"f{k}.pwn"))
        jio.save_pwn(paths[-1], jdepth_to_cloud(d, proj, JConverterConfig(min_image_radius=2, max_image_radius=7,
                                                                         min_points=10)))
    return paths, ["--rows", "120", "--cols", "160", "--fx", str(525 / 4), "--fy", str(525 / 4),
                   "--cx", str(319.5 / 4), "--cy", str(239.5 / 4)]


def _jax_converter_in_app(depth, proj, ccfg):
    """The JAX converter with the app's configs, returning the port's Cloud."""
    jp = jproj.PinholeProjector(**dataclasses.asdict(proj))
    jc = jdepth_to_cloud(jnp.asarray(depth.numpy()), jp, JConverterConfig(**dataclasses.asdict(ccfg)))
    return to_port(jc)


@pytest.mark.parametrize("kind", ["png", "pwn"])
def test_cloud_aligner_matches_jax(tmp_path, monkeypatch, kind):
    """On the same clouds: the app's inputs, configs and aligner."""
    monkeypatch.setattr(tapp, "depth_to_cloud", _jax_converter_in_app)
    paths, opts = _frames(tmp_path, kind)
    rt = tapp.run(paths + opts + ["--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        japp.main(paths + opts)
    rj = json.loads(out.getvalue().strip().splitlines()[-1])
    np.testing.assert_allclose(rt["transform"], rj["transform"], rtol=1e-4, atol=1e-5)
    assert abs(rt["inliers"] - rj["inliers"]) <= 2 and rt["inliers"] > 1000
    np.testing.assert_allclose(rt["chi2"], rj["chi2"], rtol=1e-3)
    assert rt["valid"] == rj["valid"]
    np.testing.assert_allclose(rt["t2v"], rj["t2v"], rtol=1e-4, atol=1e-5)


def test_cloud_aligner_own_clouds_matches_jax(tmp_path):
    """Each package converting its own clouds: the converters' float32
    normals differ, so T within tests/test_torch_tracker.py's 2e-3
    (observed 2.4e-5) and inliers within 1%."""
    paths, opts = _frames(tmp_path, "png")
    rt = tapp.run(paths + opts + ["--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        japp.main(paths + opts)
    rj = json.loads(out.getvalue().strip().splitlines()[-1])
    np.testing.assert_allclose(rt["transform"], rj["transform"], atol=2e-3)
    assert abs(rt["inliers"] - rj["inliers"]) <= 0.01 * rj["inliers"] and rt["valid"] == rj["valid"]
