"""PyTorch port: the captured stages (``utils/graphs.py``), the port's
counterpart of the JAX package's ``jax.jit`` on `depth_to_cloud`, `align`,
`align_batch` and the `odometry_scan` step.

On the CPU: the cache key of each public function (equal for equal shapes,
configs and projectors; different when any one of them changes; a numpy
and a tensor guess alike); a CPU call never touches ``torch.cuda``; the
`odometry_scan` step, iterated, equals the loop it replaced bit for bit and
the JAX package's ``lax.scan`` within ``tests/test_torch_tracker.py``'s
tolerances (trajectory 2e-3 m and 2e-3 in the rotation entries, inliers 2%,
fractions 0.01, keyframe flags equal); the launch counters (kernels 1-3,
the segment sums and the aligner's Gauss-Newton steps) add a key's
captured launches once a replay (a stand-in for the graph object). On the
card (skipped here): ``tools/graph_probe.py``'s checks, each graph bit-equal
to its eager body.
"""
import dataclasses

import numpy as np
import pytest
import torch

from g2o_frontend_tpu_torch.ops import fused_aligner as fa
from g2o_frontend_tpu_torch.ops import linearizer as lin
from g2o_frontend_tpu_torch.ops import se3_pcg
from g2o_frontend_tpu_torch.ops import segment_sum as ss
from g2o_frontend_tpu_torch.pwn import aligner as al
from g2o_frontend_tpu_torch.pwn import converter as cv
from g2o_frontend_tpu_torch.slam import pwn_tracker as pt
from g2o_frontend_tpu_torch.slam.pwn_matcher import stack_clouds
from g2o_frontend_tpu_torch.utils import graphs, synth
from tests import test_torch_tracker as tt
from tests.test_torch_tracker import sequence  # noqa: F401  (the tracker tests' 10 TUM frames at scale 4)

H, W = 24, 32
CCFG = cv.ConverterConfig(min_image_radius=2, max_image_radius=4, min_points=5)


@pytest.fixture(scope="module")
def pair():
    d_ref, d_cur, proj, T_gt = synth.bench_pair("cpu", H, W)
    return dict(d_ref=d_ref, d_cur=d_cur, proj=proj, T_gt=T_gt, ref=cv.depth_to_cloud(d_ref, proj, CCFG),
                cur=cv.depth_to_cloud(d_cur, proj, CCFG))


def stage_key(monkeypatch, module, attr, call):
    """The cache key that `call` gives the stage `module.attr`."""
    seen = []
    monkeypatch.setattr(module, attr, lambda *args: seen.append(graphs.key(*args)[0]))
    call()
    assert len(seen) == 1
    return seen[0]


def test_align_key(monkeypatch, pair):
    p = pair
    guess = np.linalg.inv(p["T_gt"]).astype(np.float32)
    prior = al.absolute_prior(torch.eye(4), torch.as_tensor(guess), 10.0 * torch.eye(6))

    def key(ref=p["ref"], cur=p["cur"], proj=p["proj"], guess=None, config=al.AlignerConfig(), priors=None):
        return stage_key(monkeypatch, al, "_ALIGN", lambda: al.align(ref, cur, proj, guess, config, priors))

    base = key()
    assert key() == base  # equal shapes, configs and projector
    assert key(config=al.AlignerConfig()) == base  # an equal config, another object
    assert key(config=al.AlignerConfig(outer_iterations=5)) != base
    assert key(config=al.AlignerConfig(association="zbuffer")) != base
    assert key(proj=synth.bench_projector(H, W)) == base
    assert key(proj=dataclasses.replace(p["proj"], fx=p["proj"].fx + 1)) != base
    small = cv.depth_to_cloud(p["d_ref"][:16, :16], dataclasses.replace(p["proj"], rows=16, cols=16), CCFG)
    assert key(ref=small, cur=small) != base  # a shape
    assert key(ref=type(p["ref"])(*(f.double() if f.is_floating_point() else f for f in p["ref"]))) != base
    with_guess = key(guess=torch.as_tensor(guess))
    assert with_guess != base  # initial_guess given or None
    assert key(guess=guess) == with_guess  # a numpy guess and a tensor guess
    assert key(guess=guess.astype(np.float64)) == with_guess  # converted to the clouds' dtype first
    assert key(guess=guess, priors=prior) != with_guess  # priors absent or present
    two = al.SE3Prior(torch.stack([prior.mean] * 2), torch.stack([prior.information] * 2))
    assert key(guess=guess, priors=two) != key(guess=guess, priors=prior)  # one prior or K


def test_align_batch_and_converter_keys(monkeypatch, pair):
    p = pair
    refs = stack_clouds([p["ref"], p["cur"], p["ref"]])
    guesses = np.stack([np.eye(4, dtype=np.float32)] * 3)

    def kb(refs=refs, guesses=guesses, config=al.AlignerConfig()):
        return stage_key(monkeypatch, al, "_ALIGN_BATCH",
                         lambda: al.align_batch(refs, p["cur"], p["proj"], guesses, config))

    base = kb()
    assert kb() == base and kb(guesses=torch.as_tensor(guesses)) == base
    assert kb(refs=stack_clouds([p["ref"], p["cur"]]), guesses=guesses[:2]) != base  # K
    assert kb(config=al.AlignerConfig(damping=10.0)) != base

    def kc(depth=p["d_ref"], proj=p["proj"], config=CCFG, offset=None):
        return stage_key(monkeypatch, cv, "_DEPTH_TO_CLOUD", lambda: cv.depth_to_cloud(depth, proj, config, offset))

    base = kc()
    assert kc(depth=p["d_cur"]) == base  # other values, the same key
    assert kc(depth=p["d_ref"].double()) != base  # a dtype
    assert kc(config=cv.ConverterConfig(min_image_radius=2, max_image_radius=4, min_points=6)) != base
    assert kc(offset=np.eye(4)) != base and kc(offset=np.eye(4)) == kc(offset=torch.eye(4))


def test_cpu_calls_never_touch_cuda(monkeypatch, pair):
    def forbidden(*args, **kwargs):
        raise AssertionError("a CPU call touched torch.cuda")

    for name in ("CUDAGraph", "graph", "Stream", "graph_pool_handle", "is_current_stream_capturing", "synchronize",
                 "current_stream"):
        monkeypatch.setattr(torch.cuda, name, forbidden)
    p = pair
    n = len(graphs.captures())
    cloud = cv.depth_to_cloud(p["d_cur"], p["proj"], CCFG)
    res = al.align(p["ref"], cloud, p["proj"], np.eye(4))
    batch = al.align_batch(stack_clouds([p["ref"]] * 2), cloud, p["proj"], np.stack([np.eye(4)] * 2))
    zb = al.align(p["ref"], cloud, p["proj"], config=al.AlignerConfig(association="zbuffer", outer_iterations=2))
    traj, m = pt.odometry_scan(torch.stack([p["d_ref"], p["d_cur"], p["d_ref"]]), p["proj"], CCFG, device="cpu")
    assert traj.shape == (3, 4, 4) and m["inliers"].shape == (3,)
    assert torch.allclose(batch.T[0], res.T, atol=1e-5) and torch.isfinite(zb.T).all()
    assert len(graphs.captures()) == n


def pre_pr_odometry_scan(depths, projector, ccfg, acfg, kf_fraction, min_cloud_inliers, depth_scale, device):
    """`odometry_scan` as the port wrote it before the step was captured
    (a copy, the reference of the step)."""
    depths = pt._depth_batch(depths, torch.device(device), depth_scale)
    dev = depths.device
    ref = cv.depth_to_cloud(depths[0], projector, ccfg)
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    kf_T, global_T = eye, eye
    max_inliers = projector.rows * projector.cols
    traj, inliers, fraction, keyframe, omega_tr = [eye], [], [], [], []
    for depth in depths[1:]:
        cur = cv.depth_to_cloud(depth, projector, ccfg)
        guess = torch.linalg.solve_ex(kf_T, global_T, check_errors=False).result
        res = al.align(ref, cur, projector, guess, acfg)
        ok = res.inliers >= max(1, min_cloud_inliers)
        global_T = torch.where(ok, kf_T @ res.T, global_T @ guess)
        frac = res.inliers / max_inliers
        new_kf = (frac < kf_fraction) | ~ok
        ref = type(ref)(*(torch.where(new_kf, b, a) for a, b in zip(ref, cur)))
        kf_T = torch.where(new_kf, global_T, kf_T)
        traj.append(global_T)
        inliers.append(res.inliers)
        fraction.append(frac)
        keyframe.append(new_kf)
        omega_tr.append(torch.trace(res.omega) + res.translational_ratio + res.rotational_ratio)

    def col(xs, first, dtype):
        return torch.stack([torch.full((), first, dtype=dtype, device=dev)] + [x.to(dtype) for x in xs])

    return torch.stack(traj), {
        "inliers": col(inliers, 0, torch.int32),
        "fraction": col(fraction, 1.0, torch.float32),
        "keyframe": col(keyframe, True, torch.bool),
        "omega_trace": col(omega_tr, 0.0, torch.float32),
    }


def test_scan_step_equals_the_loop_and_jax(sequence):  # noqa: F811
    s = sequence
    kw = dict(kf_fraction=tt.KF_FRACTION, min_cloud_inliers=s["min_inliers"], depth_scale=1.0 / 5000.0)
    traj, met = pt.odometry_scan(s["raw"], s["proj"], s["ccfg"], s["acfg"], **kw, device="cpu")
    traj_p, met_p = pre_pr_odometry_scan(s["raw"], s["proj"], s["ccfg"], s["acfg"], **kw, device="cpu")
    assert torch.equal(traj, traj_p)
    assert set(met) == set(met_p) and all(torch.equal(met[k], met_p[k]) for k in met)
    assert met["keyframe"].sum() > 1  # the carried reference switched

    traj_j, met_j = tt.jtracker.odometry_scan(s["raw"], s["jproj"], s["jccfg"], s["jacfg"], **kw)
    tt._assert_poses_close(traj.numpy(), np.asarray(traj_j))
    np.testing.assert_array_equal(met["keyframe"].numpy(), np.asarray(met_j["keyframe"]))
    inl_j = np.asarray(met_j["inliers"])
    assert (np.abs(met["inliers"].numpy() - inl_j) <= 0.02 * np.maximum(inl_j, 1)).all()
    np.testing.assert_allclose(met["fraction"].numpy(), np.asarray(met_j["fraction"]), atol=0.01)


class StandInGraph:
    """What `graphs.Graph` needs of a ``torch.cuda.CUDAGraph``."""

    def __init__(self, static_in, static_out):
        self.static_in, self.static_out, self.replays = static_in, static_out, 0

    def replay(self):
        self.replays += 1
        self.static_out[0].copy_(self.static_in[0] * 2)


@pytest.mark.parametrize("launches", [(11, 0, 0, 0, 10, 0), (0, 11, 0, 0, 0, 0), (0, 0, 11, 0, 0, 0),
                                      (3, 1, 2, 0, 2, 5), (0, 0, 0, 7, 0, 0), (3, 1, 2, 40, 1, 17)])
def test_replay_counts_the_captured_launches(monkeypatch, launches):
    for mod, attr in graphs.COUNTERS:
        monkeypatch.setattr(mod, attr, 5)
    static_in, static_out = [torch.zeros(3)], [torch.zeros(3)]
    out_desc = graphs.key((static_out[0],))[0][1][0]
    g = graphs.Graph(StandInGraph(static_in, static_out), static_in, static_out, out_desc, list(launches))
    outs = [g.replay([torch.full((3,), float(k))]) for k in range(1, 4)]
    assert g.graph.replays == 3
    assert [getattr(mod, attr) for mod, attr in graphs.COUNTERS] == [5 + 3 * n for n in launches]
    assert (fa.launches, fa.batch_launches, lin.launches, ss.launches, fa.step_launches, se3_pcg.launches) == tuple(
        5 + 3 * n for n in launches)
    # each call's outputs are its own clones, not the static buffers
    assert [o[0].tolist() for o in outs] == [[2.0] * 3, [4.0] * 3, [6.0] * 3]
    assert all(o[0].data_ptr() != static_out[0].data_ptr() for o in outs)


def test_stage_on_the_cpu_is_the_body():
    calls = []

    def body(x, scale, pair_):
        calls.append(1)
        return x * scale + pair_[0], pair_[1]

    stage = graphs.Stage("test body", body)
    x = torch.arange(4.0)
    out = stage(x, 2.0, (torch.ones(4), None))
    assert torch.equal(out[0], x * 2 + 1) and out[1] is None and calls == [1] and not stage._graphs


def test_stage_scan_on_the_cpu_iterates():
    def step(carry, x, k):
        return (carry[0] + k * x, carry[1] + 1), carry[0].sum()

    stage = graphs.Stage("test step", step)
    xs = torch.arange(6.0).reshape(3, 2)
    carry, outs = stage.scan((torch.zeros(2), torch.zeros(())), xs, 2.0)
    assert torch.equal(carry[0], 2 * xs.sum(0)) and float(carry[1]) == 3.0
    assert [float(o) for o in outs] == [0.0, 2.0, 12.0] and not stage._graphs
    assert stage.scan((torch.zeros(2), torch.zeros(())), xs[:0], 2.0)[1] == []


def test_mixed_devices_raise():
    stage = graphs.Stage("test mixed", lambda a, b: a + b)
    with pytest.raises(ValueError, match="several devices"):
        stage(torch.zeros(2), torch.zeros(2, device="meta"))


def test_unhashable_static_argument_raises():
    stage = graphs.Stage("test static", lambda a, d: a)
    with pytest.raises(TypeError):
        stage(torch.zeros(2), {"not": "hashable"})


def test_capture_error_names_the_first_error_and_its_line():
    def body():
        raise RuntimeError("operation not permitted when stream is capturing")

    try:
        try:
            body()
        except RuntimeError:
            raise RuntimeError("operation failed due to a previous error during capture")
    except RuntimeError as exc:
        where = graphs._where(exc)
    assert "in body" in where and "not permitted" in where and "previous error" not in where
    assert "test_torch_graphs.py" in where


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tools import graph_probe

    return graph_probe, graph_probe.inputs(torch.device("cuda"), 120, 160)


@pytest.mark.cuda
def test_replay_equals_eager_on_the_card():
    probe, x = _card()
    launches = probe.check_stages(x)
    assert launches["align"] == (11, 0, 0) and launches["align, zbuffer"] == (0, 0, 11)


@pytest.mark.cuda
def test_two_calls_do_not_alias_on_the_card():
    probe, x = _card()
    probe.check_fresh_outputs(x)


@pytest.mark.cuda
def test_another_guess_gives_its_eager_result_on_the_card():
    probe, x = _card()
    probe.check_other_guess(x)


@pytest.mark.cuda
def test_call_inside_a_capture_runs_inline_on_the_card():
    probe, x = _card()
    probe.check_inline(x)


@pytest.mark.cuda
def test_failed_capture_raises_on_the_card():
    probe, x = _card()
    assert "reads the host" in probe.check_capture_failure(x)
