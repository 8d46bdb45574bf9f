"""PyTorch port: laser/scan_matcher.py, laser/matcher_refine.py and
laser/line_extraction.py against the JAX package, on the CPU.

Inputs: tests/test_laser.py's square room (displaced poses; range noise
from a generator seeded here, `room_scan`) and scans of the port's laser-world simulator (a copy of JAX's), float32
numpy into both packages; likelihood maps cross with
`convert.likelihood_map_from_numpy`.

Tolerances:
- `build_likelihood_map`: atol 1e-5 (observed ~1e-7: the blur sums the same
  nine products in another order);
- `correlative_match`: `scores_theta` within rtol 1e-4 of JAX's; the pose
  equal, or a tie: within one cell and one theta step of JAX's pose and
  with a JAX correlation score equal to JAX's maximum within rtol 1e-4
  (the FFTs round differently, and the clamped maps have plateaus);
- `correlative_match_multires`: the fine scores within rtol 1e-5 and the
  pose equal, the same rotation and fine shift (within 1e-6 m, one float32
  rounding of base + shift * resolution); the fine level is a direct sum,
  no FFT;
- `score_pose`, `gradient_refine` (10 steps) and `hierarchical_match`:
  within 1e-4;
- `extract_lines`: mask and `n_points` equal, endpoints, normals and rho
  within atol 1e-4, against the JAX function run op by op
  (`jax.disable_jit`). Its jitted program differs from its own op-by-op run
  on some scans: a segment of a few nearly collinear points has a
  covariance that cancels to rounding noise in float32 (``sxx / c - mx *
  mx``), and XLA's fused moments give that segment another normal, so a
  merge flips (on 7 of the 27 scans of this file, the noisy room among
  them). On the scans where the jitted and the op-by-op JAX agree the port
  equals the jitted one too;
- the JAX package's gates (tests/test_laser.py:45, :61, :70, :92, :119) on
  the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.laser import line_extraction as jle
from g2o_frontend_tpu.laser import matcher_refine as jmr
from g2o_frontend_tpu.laser import scan_matcher as jsm
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.laser import line_extraction as tle
from g2o_frontend_tpu_torch.laser import matcher_refine as tmr
from g2o_frontend_tpu_torch.laser import scan_matcher as tsm
from g2o_frontend_tpu_torch.slam.simulator import LaserWorldConfig, simulate_laser_world
from tests.test_laser import square_room_scan

torch.set_num_threads(1)

SPEC = dict(rows=256, cols=256, resolution=0.05, origin_x=-6.4, origin_y=-6.4)


def _points(ranges, angles):
    r, a = np.asarray(ranges, np.float32), np.asarray(angles, np.float32)
    return np.stack([r * np.cos(a), r * np.sin(a)], -1).astype(np.float32)


def room_scan(pose=(0.0, 0.0, 0.0), noise=0.0, n_beams=360, seed=11):
    """tests/test_laser.py's square-room scan, its range noise drawn from a
    generator of this call's own (that file's draws come from one generator
    shared by every caller in the process)."""
    ranges, angles = (np.asarray(x, np.float32) for x in square_room_scan(n_beams=n_beams, pose=pose))
    return (ranges + np.random.default_rng(seed).normal(0, noise, n_beams)).astype(np.float32), angles


def _room(pose=(0.0, 0.0, 0.0), noise=0.01, n_beams=360):
    return _points(*room_scan(pose, noise, n_beams))


def _world_scans():
    w = simulate_laser_world(LaserWorldConfig(n_poses=24, n_beams=360, room=6.0, max_range=16.0, seed=3))
    return w


WORLD = _world_scans()


def _world_local(k):
    """Scan k's points and its pose relative to scan k - 3 (ground truth)."""
    gt = WORLD["gt_poses"]
    a, b = gt[k - 3], gt[k]
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    rel = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], b[2] - a[2]], np.float32)
    return _points(*WORLD["scans"][k]), _points(*WORLD["scans"][k - 3]), rel


def _case(name):
    """(reference points, scan points, valid, thetas, prior, spec kwargs)."""
    thetas = np.deg2rad(np.arange(-15, 16, 1.0)).astype(np.float32)
    if name == "room":
        cur = _room(pose=(0.35, -0.20, np.deg2rad(8.0)))
        return _room(), cur, np.ones(len(cur), bool), thetas, None, SPEC
    if name == "room_prior":
        cur = _room(pose=(0.5, 0.3, np.deg2rad(-5.0)))
        return _room(), cur, np.ones(len(cur), bool), thetas, np.array([0.4, 0.25], np.float32), SPEC
    if name == "room_masked":  # padded scan: invalid rows, and points off a small grid
        cur = _room(pose=(0.2, 0.1, np.deg2rad(3.0)))
        pad = np.concatenate([cur, np.full((152, 2), 50.0, np.float32)])
        valid = np.arange(len(pad)) < len(cur)
        spec = dict(rows=150, cols=170, resolution=0.05, origin_x=-4.1, origin_y=-3.6)
        return _room(), pad, valid, thetas, None, spec
    k = int(name.split("_")[1])
    cur, ref, rel = _world_local(k)
    th = (np.deg2rad(np.arange(-10, 10.5, 1.0)) + rel[2]).astype(np.float32)
    return ref, cur, np.ones(len(cur), bool), th, rel[:2] + np.float32(0.07), dict(rows=320, cols=320, resolution=0.05,
                                                                                   origin_x=-8.0, origin_y=-8.0)


CASES = ["room", "room_prior", "room_masked", "world_5", "world_11", "world_17", "world_23"]


def _maps(ref, spec, sigma=1.5):
    js = jsm.GridSpec(**spec)
    jm = jsm.build_likelihood_map(jnp.asarray(ref), jnp.ones(len(ref), bool), js, sigma_cells=sigma)
    tm, ts = convert.likelihood_map_from_numpy(np.asarray(jm), js, device="cpu")
    return js, jm, ts, tm


@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.2])
@pytest.mark.parametrize("name", ["room", "room_masked", "world_11"])
def test_build_likelihood_map_matches_jax(name, sigma):
    _, pts, valid, _, _, spec = _case(name)
    jm = jsm.build_likelihood_map(jnp.asarray(pts), jnp.asarray(valid), jsm.GridSpec(**spec), sigma_cells=sigma)
    tm = tsm.build_likelihood_map(torch.as_tensor(pts), torch.as_tensor(valid), tsm.GridSpec(**spec),
                                  sigma_cells=sigma)
    assert tm.shape == (spec["rows"], spec["cols"]) and float(tm.max()) == 1.0
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)


def _jax_corr_score(jm, pts, valid, js, theta, prior, pose):
    """JAX's correlation score of the shift that puts the scan at `pose`:
    sum img[y, x] map[y + sy, x + sx] over JAX's rendered scan (circular)."""
    c, s = np.cos(theta), np.sin(theta)
    rot = pts @ np.array([[c, -s], [s, c]], np.float32).T + prior
    img = np.asarray(jsm._render_scan(jnp.asarray(rot), jnp.asarray(valid), js))
    sx = int(round((pose[0] - prior[0]) / js.resolution))
    sy = int(round((pose[1] - prior[1]) / js.resolution))
    return float(np.sum(img * np.roll(np.asarray(jm), (-sy, -sx), (0, 1))))


@pytest.mark.parametrize("name", CASES)
def test_correlative_match_matches_jax(name):
    ref, pts, valid, thetas, prior, spec = _case(name)
    js, jm, ts, tm = _maps(ref, spec)
    jp = None if prior is None else jnp.asarray(prior)
    rj = jsm.correlative_match(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(thetas),
                               search_radius_cells=20, translation_prior=jp)
    rt = tsm.correlative_match(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts, torch.as_tensor(thetas),
                               search_radius_cells=20, translation_prior=None if prior is None else torch.as_tensor(prior))
    np.testing.assert_allclose(rt.scores_theta.numpy(), np.asarray(rj.scores_theta), rtol=1e-4)
    pj, pt = np.asarray(rj.pose), rt.pose.numpy()
    if not np.array_equal(pj, pt):  # a tie
        assert np.abs(pj[:2] - pt[:2]).max() <= js.resolution * 1.01 and abs(pj[2] - pt[2]) <= 1.01 * np.deg2rad(1)
        k = int(np.argmin(np.abs(thetas - pt[2])))
        score = _jax_corr_score(jm, pts, valid, js, thetas[k], np.zeros(2) if prior is None else prior, pt)
        np.testing.assert_allclose(score, float(rj.score), rtol=1e-4)
    np.testing.assert_allclose(float(rt.score), float(rj.score), rtol=1e-4)


@pytest.mark.parametrize("coarse_factor", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_correlative_match_multires_matches_jax(name, coarse_factor):
    ref, pts, valid, thetas, prior, spec = _case(name)
    js, jm, ts, tm = _maps(ref, spec)
    rj = jsm.correlative_match_multires(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(thetas),
                                        search_radius_cells=30, coarse_factor=coarse_factor,
                                        translation_prior=None if prior is None else jnp.asarray(prior))
    rt = tsm.correlative_match_multires(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts,
                                        torch.as_tensor(thetas), search_radius_cells=30,
                                        coarse_factor=coarse_factor,
                                        translation_prior=None if prior is None else torch.as_tensor(prior))
    np.testing.assert_allclose(rt.scores_theta.numpy(), np.asarray(rj.scores_theta), rtol=1e-5)
    # the same theta and fine shift: equal up to the float32 rounding of
    # base + shift * resolution (XLA may fuse it into one multiply-add)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=1e-6)
    assert rt.scores_theta.dtype == torch.float32 and rt.pose.dtype == torch.float32


def test_fine_scores_are_exact_sums():
    """The fine level's float64 sum of float32 terms does not depend on the
    order of the points (so the card and the CPU give one number)."""
    ref, pts, valid, thetas, prior, spec = _case("world_11")
    _, _, ts, tm = _maps(ref, spec)
    perm = np.random.default_rng(0).permutation(len(pts))
    args = (torch.as_tensor(thetas), torch.as_tensor(prior), 9)
    a = tsm.fine_scores(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts, *args)
    b = tsm.fine_scores(tm, torch.as_tensor(pts[perm]), torch.as_tensor(valid[perm]), ts, *args)
    assert a.dtype == torch.float64 and torch.equal(a, b)


@pytest.mark.parametrize("name", ["room", "world_11"])
def test_score_pose_and_gradient_refine_match_jax(name):
    ref, pts, valid, _, prior, spec = _case(name)
    js, jm, ts, tm = _maps(ref, spec)
    p0 = np.array([0.3, -0.15, 0.12], np.float32) if prior is None else np.array([*prior, 0.0], np.float32)
    np.testing.assert_allclose(
        float(tmr.score_pose(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts, torch.as_tensor(p0))),
        float(jmr.score_pose(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(p0))), rtol=1e-5)
    pj, sj = jmr.gradient_refine(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(p0), steps=10)
    pt, st = tmr.gradient_refine(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts, torch.as_tensor(p0), steps=10)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), atol=1e-4)
    assert float(st) > float(tmr.score_pose(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts,
                                            torch.as_tensor(p0)))


def test_hierarchical_match_matches_jax():
    """The coarse search as `correlative_match` (equal or tied), then the
    polish from the port's coarse pose as JAX's from the same pose."""
    ref, pts, valid, thetas, _, spec = _case("room")
    js, jm, ts, tm = _maps(ref, spec)
    pj, sj, cj = jmr.hierarchical_match(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(thetas),
                                        gradient_steps=5)
    pt, st, ct = tmr.hierarchical_match(tm, torch.as_tensor(pts), torch.as_tensor(valid), ts, torch.as_tensor(thetas),
                                        gradient_steps=5)
    np.testing.assert_allclose(ct.scores_theta.numpy(), np.asarray(cj.scores_theta), rtol=1e-4)
    np.testing.assert_allclose(float(ct.score), float(cj.score), rtol=1e-4)
    assert np.abs(ct.pose.numpy() - np.asarray(cj.pose)).max() <= 4 * 0.05 * 1.01  # a tie within one coarse cell
    pj, sj = jmr.gradient_refine(jm, jnp.asarray(pts), jnp.asarray(valid), js, jnp.asarray(ct.pose.numpy()), steps=5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(float(st), float(sj), atol=1e-4)


def test_correlative_matcher_gates():
    """tests/test_laser.py:92 and :119 on the port alone."""
    spec = tsm.GridSpec(**SPEC)
    pts0 = torch.as_tensor(_room(noise=0.0))
    lmap = tsm.build_likelihood_map(pts0, torch.ones(len(pts0), dtype=torch.bool), spec, sigma_cells=1.5)
    pose_gt = (0.35, -0.20, np.deg2rad(8.0))
    pts1 = torch.as_tensor(_room(pose=pose_gt, noise=0.0))
    thetas = torch.as_tensor(np.deg2rad(np.arange(-15, 16, 1.0)), dtype=torch.float32)
    pose = tsm.correlative_match(lmap, pts1, torch.ones(len(pts1), dtype=torch.bool), spec, thetas,
                                 search_radius_cells=20).pose.numpy()
    assert abs(pose[2] - pose_gt[2]) < np.deg2rad(1.5) and np.abs(pose[:2] - pose_gt[:2]).max() < 0.08, pose
    spec = tsm.GridSpec(rows=128, cols=128, resolution=0.1, origin_x=-6.4, origin_y=-6.4)
    pts0 = torch.as_tensor(_room(noise=0.0, n_beams=180))
    valid = torch.ones(len(pts0), dtype=torch.bool)
    lmap = tsm.build_likelihood_map(pts0, valid, spec, sigma_cells=1.0)
    thetas = torch.as_tensor(np.deg2rad(np.arange(-5, 6, 1.0)), dtype=torch.float32)
    pose = tsm.correlative_match(lmap, pts0, valid, spec, thetas, search_radius_cells=10).pose.numpy()
    np.testing.assert_allclose(pose, [0, 0, 0], atol=0.11)


# -- line extraction --------------------------------------------------------------


def _scan(name):
    if name.startswith("room"):
        pose, noise = {"room": ((0, 0, 0), 0.01), "room_displaced": ((0.5, -0.3, 0.4), 0.0),
                       "room_dropouts": ((0, 0, 0), 0.0)}[name]
        r, a = room_scan(pose, noise)
        if name == "room_dropouts":
            r = r.copy()
            r[100:120] = 0.0
        return r, a
    r, a = WORLD["scans"][int(name.split("_")[1])]
    return np.asarray(r, np.float32), np.asarray(a, np.float32)


LINE_SCANS = ["room", "room_displaced", "room_dropouts", "world_0", "world_4", "world_9", "world_15", "world_21"]
CFGS = {"default": {}, "split": dict(min_points_in_line=10, split_threshold=0.05**2)}


def _lines_equal(lt, lj):
    np.testing.assert_array_equal(lt.mask.numpy(), np.asarray(lj.mask))
    np.testing.assert_array_equal(lt.n_points.numpy(), np.asarray(lj.n_points))
    for f in ("p0", "p1", "normal", "rho"):
        np.testing.assert_allclose(getattr(lt, f).numpy(), np.asarray(getattr(lj, f)), atol=1e-4, err_msg=f)


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("name", LINE_SCANS)
def test_extract_lines_matches_jax(name, cfg):
    r, a = _scan(name)
    with jax.disable_jit():
        lj = jle.extract_lines(jnp.asarray(r), jnp.asarray(a), jle.LineExtractorConfig(**CFGS[cfg]))
    lt = tle.extract_lines(torch.as_tensor(r), torch.as_tensor(a), tle.LineExtractorConfig(**CFGS[cfg]))
    assert int(lt.mask.sum()) >= 3
    _lines_equal(lt, lj)


@pytest.mark.parametrize("name", ["room_displaced", "room_dropouts", "world_4", "world_9", "world_21"])
def test_extract_lines_matches_jitted_jax(name):
    r, a = _scan(name)
    lj = jle.extract_lines(jnp.asarray(r), jnp.asarray(a))
    _lines_equal(tle.extract_lines(torch.as_tensor(r), torch.as_tensor(a)), lj)


def test_line_extraction_gates():
    """tests/test_laser.py:45, :61 and :70 on the port alone."""
    r, a = (torch.as_tensor(x) for x in room_scan())
    ls = tle.extract_lines(r, a, tle.LineExtractorConfig(min_points_in_line=10))
    m = ls.mask
    assert 4 <= int(m.sum()) <= 6
    assert bool((ls.normal[m].abs().amax(1) > 0.99).all())
    np.testing.assert_allclose(ls.rho[m].numpy(), 4.0, atol=0.1)
    rn, an = (torch.as_tensor(x) for x in room_scan(noise=0.01))
    ls = tle.extract_lines(rn, an, tle.LineExtractorConfig(min_points_in_line=10, split_threshold=0.05**2))
    assert 4 <= int(ls.mask.sum()) <= 8
    np.testing.assert_allclose(ls.rho[ls.mask].numpy(), 4.0, atol=0.15)
    r = r.clone()
    r[100:120] = 0.0
    ls = tle.extract_lines(r, a)
    assert float(ls.n_points[ls.mask].sum()) <= 360 - 20


def test_likelihood_map_from_numpy():
    js = jsm.GridSpec(**SPEC)
    grid = np.random.default_rng(1).random((SPEC["rows"], SPEC["cols"])).astype(np.float32)
    tm, ts = convert.likelihood_map_from_numpy(grid, js, device="cpu")
    assert ts == tsm.GridSpec(**SPEC) and tm.dtype == torch.float32 and np.array_equal(tm.numpy(), grid)
