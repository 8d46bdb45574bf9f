"""PyTorch port: the RANSAC solvers and engine against the JAX package.

Inputs: tests/test_ransac.py's protocols (`ransac_test.cpp:84-205`: random
items, a ground-truth transform, noise, planted outliers), made from a
seed with numpy and fed to both packages on the CPU in float32.

Tolerances:
- every fit of `ransac/solvers.py`, on the exact and the noisy-with-
  outliers data, with all-ones and random weights and with the inlier
  mask (the refinement's weights): within rtol 1e-5 of JAX's (relative to
  the transform's largest entry, at least 1); every err function within
  the same rtol of its largest error;
- a batch of 16 one-hot minimal sets on the exact data (the engine's
  hypothesis batch, JAX's `vmap`) within rtol 1e-4: a minimal set is as
  well conditioned as its geometry, and three near-collinear points
  (se3_points) or two near-parallel line normals (se2_lines) amplify the
  float32 rounding of the sums to 1e-5-3e-5. A minimal set that mixes
  outliers is not compared: three inconsistent plane normals leave the
  Wahba matrix's top eigenvalues close and its 8-squaring power iteration
  unconverged, the two packages 7.6e-5 apart (se3_planes);
- the engine, fed JAX's own `_sample_minimal_sets` draws: the inlier mask
  and count equal, the transform within 1e-5, on the Horn2D, Horn3D and
  plane outlier cases, the masked case and the case with fewer valid
  entries than the minimal set;
- the port's own draws (a CPU `torch.Generator`): the recovery gates of
  tests/test_ransac.py;
- `ate_xy` within 1e-5 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ransac import engine as jengine
from g2o_frontend_tpu.ransac import solvers as jsolvers
from g2o_frontend_tpu.utils import evaluation as jevaluation
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu_torch.ransac import engine as tengine
from g2o_frontend_tpu_torch.ransac import solvers as tsolvers
from g2o_frontend_tpu_torch.utils import evaluation as tevaluation

torch.set_num_threads(1)

RTOL = 1e-5


def _T_gt():
    xi = np.array([0.3, -0.2, 0.5, 0.2, -0.1, 0.3], np.float32)
    return np.asarray(jlie.se3_exp(jnp.asarray(xi)))


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _data(kind, outliers, rng):
    """(d1, d2, minimal size) of one solver family: exact, or with noise
    and a share of gross outliers."""
    T = _T_gt()
    x = np.array([1.2, -0.5, 0.9], np.float32)
    if kind == "se2_points":
        d2 = rng.uniform(-5, 5, (60, 2)).astype(np.float32)
        d1 = np.asarray(jlie.se2_apply(jnp.asarray(x), jnp.asarray(d2)))
        m = 2
    elif kind == "se3_points":
        d2 = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
        d1 = d2 @ T[:3, :3].T + T[:3, 3]
        m = 3
    elif kind == "se2_poses":
        d2 = rng.normal(size=(30, 3)).astype(np.float32)
        d1 = np.asarray(jax.vmap(lambda b: jlie.se2_compose(jnp.asarray(x), b))(jnp.asarray(d2)))
        m = 1
    elif kind == "se3_poses":
        d2 = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(rng.normal(size=(30, 6)) * 0.4, jnp.float32)))
        d1 = np.einsum("ij,njk->nik", T, d2).astype(np.float32)
        m = 1
    elif kind == "se2_lines":
        a = rng.uniform(0, 2 * np.pi, 40)
        d2 = np.stack([np.cos(a), np.sin(a), rng.uniform(-2, 2, 40)], -1).astype(np.float32)
        c, s = np.cos(x[2]), np.sin(x[2])
        n1 = d2[:, :2] @ np.array([[c, -s], [s, c]], np.float32).T
        d1 = np.concatenate([n1, (d2[:, 2] + n1 @ x[:2])[:, None]], -1).astype(np.float32)
        m = 2
    elif kind == "se3_planes":
        n2 = _unit(rng, 40)
        off = rng.uniform(-2, 2, 40).astype(np.float32)
        n1 = n2 @ T[:3, :3].T
        d1 = np.concatenate([n1, (off + n1 @ T[:3, 3])[:, None]], -1).astype(np.float32)
        d2 = np.concatenate([n2, off[:, None]], -1)
        m = 3
    else:  # se3_lines
        dirs, pts = _unit(rng, 40), rng.normal(size=(40, 3)).astype(np.float32)
        d1 = np.concatenate([dirs @ T[:3, :3].T, pts @ T[:3, :3].T + T[:3, 3]], -1).astype(np.float32)
        d2 = np.concatenate([dirs, pts], -1)
        m = 3
    d1 = np.array(d1, np.float32)
    out = np.zeros(len(d1), bool)
    if outliers:
        d1 = d1 + rng.normal(0, 0.01, d1.shape).astype(np.float32)
        out = rng.random(len(d1)) < 0.3
        d1[out] = rng.permutation(d1)[: out.sum()]  # gross outliers: other items' values
    return d1, np.asarray(d2, np.float32), m, out


KINDS = ["se2_points", "se3_points", "se2_poses", "se3_poses", "se2_lines", "se3_planes", "se3_lines"]


def _close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("outliers", [False, True], ids=["exact", "outliers"])
@pytest.mark.parametrize("kind", KINDS)
def test_fit_and_err_match_jax(kind, outliers):
    rng = np.random.default_rng(KINDS.index(kind) + 10 * outliers)
    d1, d2, m, out = _data(kind, outliers, rng)
    n = len(d1)
    jfit, jerr = getattr(jsolvers, f"fit_{kind}"), getattr(jsolvers, f"err_{kind}")
    tfit, terr = getattr(tsolvers, f"fit_{kind}"), getattr(tsolvers, f"err_{kind}")
    # all ones, the inlier mask, random weights and, on exact data, one-hot
    # minimal sets (the engine's batch)
    W = np.concatenate([np.ones((1, n), np.float32), (~out)[None].astype(np.float32),
                        rng.random((3, n)).astype(np.float32)])
    if not outliers:
        sets = np.stack([rng.choice(n, m, replace=False) for _ in range(16)])
        onehot = np.zeros((16, n), np.float32)
        np.put_along_axis(onehot, sets, 1.0, 1)
        W = np.concatenate([W, onehot])
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    ref = np.stack([np.asarray(jfit(j1, j2, jnp.asarray(w))) for w in W])
    t1, t2 = torch.as_tensor(d1), torch.as_tensor(d2)
    port = tfit(t1, t2, torch.as_tensor(W)).numpy()
    _close(port[:5], ref[:5])
    for k in range(5, len(W)):
        _close(port[k], ref[k], rtol=1e-4)
    # errors of every hypothesis, batched in the port
    e_ref = np.stack([np.asarray(jerr(jnp.asarray(T), j1, j2)) for T in ref])
    e_port = terr(torch.as_tensor(ref), t1, t2).numpy()
    _close(e_port, e_ref)
    # the all-ones fit of the exact data, and the inliers' fit, recover
    # the transform
    assert float(e_port[1][~out].max()) < (1e-6 if not outliers else 1e-2)


def _case(name, rng):
    """(d1, d2, mask, fit/err name, minimal size, threshold, hypotheses,
    min inliers): tests/test_ransac.py's engine cases."""
    x_gt = jnp.array([1.2, -0.5, 0.9])
    if name == "horn2d":
        N = 100
        p2 = rng.uniform(-5, 5, (N, 2)).astype(np.float32)
        p1 = np.array(jlie.se2_apply(x_gt, jnp.asarray(p2))) + rng.normal(0, 0.01, (N, 2)).astype(np.float32)
        out = rng.random(N) < 0.4
        p1[out] = rng.uniform(-5, 5, (out.sum(), 2))
        return p1, p2, np.ones(N, bool), "se2_points", 2, 0.05**2, 256, 4
    if name == "horn3d":
        N, T = 120, _T_gt()
        p2 = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
        p1 = (p2 @ T[:3, :3].T + T[:3, 3] + rng.normal(0, 0.01, (N, 3))).astype(np.float32)
        out = rng.random(N) < 0.3
        p1[out] = rng.uniform(-3, 3, (out.sum(), 3))
        return p1, p2, np.ones(N, bool), "se3_points", 3, 0.05**2, 512, 4
    if name == "planes":
        N, T = 40, _T_gt()
        n2 = _unit(rng, N)
        off = rng.uniform(-2, 2, N).astype(np.float32)
        n1 = n2 @ T[:3, :3].T + rng.normal(0, 0.005, (N, 3))
        n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
        o1 = off + n1 @ T[:3, 3] + rng.normal(0, 0.005, N)
        out = rng.random(N) < 0.25
        n1[out] = _unit(rng, int(out.sum()))
        o1[out] = rng.uniform(-2, 2, out.sum())
        pl1 = np.concatenate([n1, o1[:, None]], -1).astype(np.float32)
        pl2 = np.concatenate([n2, off[:, None]], -1).astype(np.float32)
        return pl1, pl2, np.ones(N, bool), "se3_planes", 3, 0.03, 512, 3
    N = 50
    p2 = rng.uniform(-4, 4, (N, 2)).astype(np.float32)
    p1 = np.array(jlie.se2_apply(jnp.array([0.4, 0.2, -0.3]), jnp.asarray(p2)))
    mask = np.ones(N, bool)
    if name == "masked":
        mask[30:] = False
        p1[30:] = 1e3  # garbage in the masked region
    else:  # "one_valid": fewer valid entries than the minimal set
        mask[1:] = False
    return p1, p2, mask, "se2_points", 2, 1e-4, 128, 4


@pytest.mark.parametrize("name", ["horn2d", "horn3d", "planes", "masked", "one_valid"])
def test_engine_with_jax_draws_matches_jax(name):
    rng = np.random.default_rng(3)
    d1, d2, mask, kind, m, thr, K, min_inl = _case(name, rng)
    key = jax.random.PRNGKey(7)
    ref = jengine.ransac(key, jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask),
                         fit_fn=getattr(jsolvers, f"fit_{kind}"), err_fn=getattr(jsolvers, f"err_{kind}"),
                         minimal_size=m, inlier_threshold=thr, n_hypotheses=K, min_inliers=min_inl)
    sets = np.asarray(jengine._sample_minimal_sets(key, K, m, len(d1), jnp.asarray(mask)))
    res = tengine.ransac(None, torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(mask),
                         getattr(tsolvers, f"fit_{kind}"), getattr(tsolvers, f"err_{kind}"), m, thr, K, min_inl,
                         minimal_sets=torch.as_tensor(sets))
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(ref.inliers))
    assert int(res.n_inliers) == int(ref.n_inliers)
    assert bool(res.ok) == bool(ref.ok)
    _close(res.transform.numpy(), np.asarray(ref.transform))
    _close(res.error.numpy(), np.asarray(ref.error))
    if name == "one_valid":  # one valid entry cannot make a 2-point set
        assert not bool(res.ok) and int(res.n_inliers) <= 1


def test_sample_minimal_sets_like_jax():
    """Distinct indices among the valid entries; with fewer valid entries
    than the set, the valid ones then the lowest masked ones, in index
    order, as JAX's `lax.top_k` takes its -inf ties."""
    g = torch.Generator().manual_seed(0)
    mask = np.zeros(40, bool)
    mask[[3, 7, 11, 20, 33]] = True
    sets = tengine._sample_minimal_sets(g, 500, 3, torch.as_tensor(mask)).numpy()
    assert sets.shape == (500, 3) and np.all(mask[sets])
    assert all(len(set(s)) == 3 for s in sets)
    assert len(np.unique(sets)) == 5  # every valid entry gets drawn
    few = np.zeros(8, bool)
    few[5] = True
    port = tengine._sample_minimal_sets(g, 4, 3, torch.as_tensor(few)).numpy()
    ref = np.asarray(jengine._sample_minimal_sets(jax.random.PRNGKey(0), 4, 3, 8, jnp.asarray(few)))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, np.tile([5, 0, 1], (4, 1)))
    # one generator state, one draw: two generators of one seed agree
    a = tengine._sample_minimal_sets(torch.Generator().manual_seed(9), 16, 2, torch.ones(12, dtype=torch.bool))
    b = tengine._sample_minimal_sets(torch.Generator().manual_seed(9), 16, 2, torch.ones(12, dtype=torch.bool))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["horn2d", "horn3d", "planes", "masked"])
def test_engine_own_draws_recovers(name):
    """tests/test_ransac.py's recovery gates, the port alone."""
    rng = np.random.default_rng(3)
    d1, d2, mask, kind, m, thr, K, min_inl = _case(name, rng)
    res = tengine.ransac(torch.Generator().manual_seed(0), torch.as_tensor(d1), torch.as_tensor(d2),
                         torch.as_tensor(mask), getattr(tsolvers, f"fit_{kind}"), getattr(tsolvers, f"err_{kind}"),
                         m, thr, K, min_inl)
    assert bool(res.ok)
    T = res.transform.numpy()
    if kind == "se2_points":
        x_gt = [0.4, 0.2, -0.3] if name == "masked" else [1.2, -0.5, 0.9]
        np.testing.assert_allclose(T, x_gt, atol=0.02)
        if name == "masked":
            assert int(res.n_inliers) == 30
    else:
        err = np.linalg.inv(_T_gt()) @ T
        assert np.linalg.norm(err[:3, 3]) < 0.05
        assert np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)) < 0.02


def test_ate_xy_matches_jax():
    rng = np.random.default_rng(4)
    gt = rng.uniform(-10, 10, (200, 2))
    c, s = np.cos(0.3), np.sin(0.3)
    est = gt @ np.array([[c, -s], [s, c]]).T + [2.0, -1.0] + rng.normal(0, 0.1, gt.shape)
    for align in (True, False):
        port, ref = tevaluation.ate_xy(est, gt, align), jevaluation.ate_xy(est, gt, align)
        assert port["pairs"] == ref["pairs"] == 200
        for k in ("rmse", "mean", "max"):
            assert abs(port[k] - ref[k]) <= 1e-5 * max(1.0, ref[k]), (k, port[k], ref[k])
    assert tevaluation.ate_xy(est, gt)["rmse"] < 0.2
