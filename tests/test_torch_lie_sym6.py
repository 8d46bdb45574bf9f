"""PyTorch port: SE3 Lie maps and sym6 algebra against the JAX package.

Inputs are made with numpy from a seed and given to both; JAX runs on the
CPU. Everything is float32. Tolerances (absolute):
- rotation/transform entries (|x| <= 1 or translations ~1 m): 2e-6;
- so3_log/se3_log away from pi: 1e-5 ("near zero" is th <= 1e-2, the
  float32 series branches; just above that threshold the generic se3_log
  branch cancels and both packages sit ~2e-5 from the float64 value); near pi (th in [pi-0.03, pi)) the
  axis comes from sqrt of the diagonal, whose float32 conditioning is
  ~sqrt(eps), so 2e-3;
- sym6 products of O(1) random planes: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ops import sym6 as jsym6
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu_torch.ops import sym6 as tsym6
from g2o_frontend_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)


def _axis_angles(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if kind == "random":
        ang = rng.uniform(0.0, 3.0, n)
    elif kind == "near_zero":
        ang = 10.0 ** rng.uniform(-7.0, -2.0, n)  # the series branches' domain
    else:  # near_pi
        ang = np.pi - 10.0 ** rng.uniform(-4.0, -1.5, n)
    return (axis * ang[:, None]).astype(np.float32)


def _jax(fn, x):
    return np.asarray(jax.vmap(fn)(jnp.asarray(x)))


def _torch(fn, x):
    return fn(torch.from_numpy(np.array(x))).numpy()


KINDS = ["random", "near_zero", "near_pi"]


@pytest.mark.parametrize("kind", KINDS)
def test_so3_exp_log(kind):
    w = _axis_angles(kind)
    Rj, Rt = _jax(jlie.so3_exp, w), _torch(tlie.so3_exp, w)
    np.testing.assert_allclose(Rt, Rj, atol=2e-6)
    atol = 2e-3 if kind == "near_pi" else 1e-5
    np.testing.assert_allclose(_torch(tlie.so3_log, Rj), _jax(jlie.so3_log, Rj), atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_se3_exp_log(kind):
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(scale=0.5, size=(64, 3)).astype(np.float32), _axis_angles(kind, seed=2)], 1)
    Tj, Tt = _jax(jlie.se3_exp, xi), _torch(tlie.se3_exp, xi)
    np.testing.assert_allclose(Tt, Tj, atol=2e-6)
    logj, logt = _jax(jlie.se3_log, Tj), _torch(tlie.se3_log, Tj)
    assert np.isfinite(logt).all()
    atol = 2e-3 if kind == "near_pi" else 1e-5
    np.testing.assert_allclose(logt, logj, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_quaternion_chart(kind):
    R = _jax(jlie.so3_exp, _axis_angles(kind, seed=3))
    np.testing.assert_allclose(_torch(tlie.mat2quat_full, R), _jax(jlie.mat2quat_full, R), atol=2e-6)
    rng = np.random.default_rng(4)
    T = np.tile(np.eye(4, dtype=np.float32), (len(R), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.normal(size=(len(R), 3))
    v = _jax(jlie.se3_t2v, T)
    np.testing.assert_allclose(_torch(tlie.se3_t2v, T), v, atol=2e-6)
    np.testing.assert_allclose(_torch(tlie.se3_v2t, v), _jax(jlie.se3_v2t, v), atol=2e-6)
    np.testing.assert_allclose(_torch(tlie.quat2mat, v[:, 3:]), _jax(jlie.quat2mat, v[:, 3:]), atol=2e-6)
    np.testing.assert_allclose(_torch(tlie.se3_inverse, T), _jax(jlie.se3_inverse, T), atol=2e-6)
    np.testing.assert_allclose(_torch(tlie.skew, v[:, :3]), _jax(jlie.skew, v[:, :3]), atol=0)


def test_lie_single_element_and_jacfwd():
    """Unbatched inputs work, and forward-mode differentiation goes through
    the chart (the aligner's prior jacobians need it)."""
    xi = torch.tensor([0.1, -0.2, 0.3, 0.02, -0.01, 0.03])
    T = tlie.se3_v2t(xi)
    assert T.shape == (4, 4)
    np.testing.assert_allclose(tlie.se3_t2v(T).numpy(), xi.numpy(), atol=1e-6)
    J = torch.func.jacfwd(lambda e: tlie.se3_t2v(tlie.se3_v2t(e) @ T))(torch.zeros(6))
    Jj = jax.jacfwd(lambda e: jlie.se3_t2v(jlie.se3_v2t(e) @ jnp.asarray(T.numpy())))(jnp.zeros(6))
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-5)


def test_sym6():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(6, 7, 9)).astype(np.float32)
    v = rng.normal(size=(3, 7, 9)).astype(np.float32)
    R = np.array(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    ot, vt, Rt = torch.from_numpy(o), torch.from_numpy(v), torch.from_numpy(R)
    oj, vj, Rj = jnp.asarray(o), jnp.asarray(v), jnp.asarray(R)

    def close(a, b):
        np.testing.assert_allclose(np.stack([np.asarray(x) for x in a]), np.stack([np.asarray(x) for x in b]), atol=1e-5)

    np.testing.assert_allclose(tsym6.sym_mat(ot).numpy(), np.asarray(jsym6.sym_mat(oj)), atol=0)
    close(tsym6.sym_apply(ot, vt), jsym6.sym_apply(oj, vj))
    np.testing.assert_allclose(tsym6.sym_rotate(Rt, ot).numpy(), np.asarray(jsym6.sym_rotate(Rj, oj)), atol=1e-5)
    close(tsym6.rot_apply(Rt, vt), jsym6.rot_apply(Rj, vj))
    V = [tuple(vt), tuple(torch.from_numpy(o[:3])), tuple(torch.from_numpy(o[3:]))]
    Vj = [tuple(vj), tuple(jnp.asarray(o[:3])), tuple(jnp.asarray(o[3:]))]
    np.testing.assert_allclose(
        tsym6.sym_from_diag_frame(V, tuple(vt)).numpy(),
        np.asarray(jsym6.sym_from_diag_frame(Vj, tuple(vj))),
        atol=1e-5,
    )
