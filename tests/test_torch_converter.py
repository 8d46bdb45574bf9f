"""PyTorch port: projector, integral image, eigh3x3 and depth_to_cloud
against the JAX package, on the `_scene` of tests/test_fused_aligner.py
(96x128) and on one frame of eval_out/tum_seq at scale 4 (120x160).

The converter's window moments come from float32 integral images, whose
sums of p p^T lose digits; PyTorch and XLA also sum in different orders.
So besides the direct comparison, each cloud field is held against the
port run in float64, and the port must be about as close to it as JAX is.

Tolerances and the shares they allow (of valid pixels):
- valid: equal; points: atol 1e-6;
- window count n: equal; mean: atol 3e-4 m (observed 1.2e-4 on the TUM
  frame); cov6: atol 1e-3 m^2; RMS error against float64 at most 1.5x
  JAX's;
- curvature atol 1e-2, normals atol 2e-2 per component, eigenvalues atol
  1e-3, point omegas atol 20 (of 1000), normal omegas atol 1e-3: at most 2%
  of pixels beyond tolerance (observed <= 1.4%, curvature on the TUM
  frame), and the port's share against float64 at most 1.5x JAX's + 0.5%;
- has-normal flips between the packages: at most 1% (observed 0.4%).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.io import tum
from g2o_frontend_tpu.ops import eigh3x3 as jeig
from g2o_frontend_tpu.ops import integral_image as jii
from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig
from g2o_frontend_tpu.pwn.converter import depth_to_cloud as j_depth_to_cloud
from g2o_frontend_tpu.pwn.projector import PinholeProjector as JPinholeProjector
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.apps.pwn_odometry import configs
from g2o_frontend_tpu_torch.ops import eigh3x3 as teig
from g2o_frontend_tpu_torch.ops import integral_image as tii
from g2o_frontend_tpu_torch.pwn.converter import depth_to_cloud as t_depth_to_cloud
from g2o_frontend_tpu_torch.pwn.converter import radius_levels
from g2o_frontend_tpu_torch.utils import synth as tsynth

torch.set_num_threads(1)

SCENE_CCFG = dict(min_image_radius=3, max_image_radius=8, min_points=12)
FIELD_TOL = {"curv": 1e-2, "n": 2e-2, "ev": 1e-3, "op": 20.0, "on": 1e-3}


def _case(name):
    """(JAX projector, JAX converter config, depth (H, W) float32 numpy)."""
    if name.startswith("scene"):
        proj = default_projector(H=96, W=128)
        levels = 0 if name == "scene_exact" else 4
        ccfg = JConverterConfig(n_radius_levels=levels, **SCENE_CCFG)
        return proj, ccfg, np.array(render_planes_depth(np.eye(4), proj))
    tproj, tccfg, _ = configs(4, "kinect")
    proj = JPinholeProjector(**{k: getattr(tproj, k) for k in tproj.__dataclass_fields__})
    ccfg = JConverterConfig(
        min_image_radius=tccfg.min_image_radius,
        max_image_radius=tccfg.max_image_radius,
        min_points=tccfg.min_points,
    )
    depth = tum.load_depth_png("eval_out/tum_seq/depth/1.000000.png")[::4, ::4]
    return proj, ccfg, np.ascontiguousarray(depth)


CASES = ["scene", "scene_exact", "tum_scale4"]


def test_projector_unproject_project():
    proj = default_projector(H=96, W=128)
    tproj = convert.config_from(proj)
    assert tproj.scaled(2) == convert.config_from(proj.scaled(2))
    depth = np.array(render_planes_depth(np.eye(4), proj))
    pj, vj = proj.unproject(jnp.asarray(depth))
    pt, vt = tproj.unproject(torch.from_numpy(depth))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_array_equal(
        tproj.project_intervals(torch.from_numpy(depth), 0.1).numpy(),
        np.asarray(proj.project_intervals(jnp.asarray(depth), 0.1)),
    )
    # render the cloud from a moved camera: the z-buffer ids must be equal
    T = np.asarray(jlie.se3_v2t(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.008, 0.006], jnp.float32)))
    moved = np.asarray(pj) @ T[:3, :3].T + T[:3, 3]
    dj, ij = proj.project(jnp.asarray(moved), vj)
    dt, it = tproj.project(torch.from_numpy(moved.astype(np.float32)), vt)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it.numpy() >= 0).mean() > 0.9


def test_synth_matches_jax():
    proj = default_projector(H=48, W=64)
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.05, 0.2]
    np.testing.assert_array_equal(
        tsynth.render_planes_depth(T, convert.config_from(proj)).numpy(),
        np.asarray(render_planes_depth(T, proj)),
    )
    assert convert.config_from(proj) == tsynth.default_projector(H=48, W=64)


def test_integral_image_and_window_sums():
    """On small integers every sum is exact in float32, so the port must
    equal JAX bit for bit; window radii cover clipping at the borders."""
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, size=(4, 23, 31)).astype(np.float32)
    radii = rng.integers(0, 9, size=(23, 31)).astype(np.int32)
    Ij = jii.integral_image_planar(jnp.asarray(x))
    It = tii.integral_image_planar(torch.from_numpy(x))
    np.testing.assert_array_equal(It.numpy(), np.asarray(Ij))
    for r in (0, 3, 8):
        np.testing.assert_array_equal(
            tii.window_sums_fixed_planar(It, r).numpy(), np.asarray(jii.window_sums_fixed_planar(Ij, r))
        )
    levels = (2, 4, 7)
    np.testing.assert_array_equal(
        tii.window_sums_quantized_planar(It, torch.from_numpy(radii), levels).numpy(),
        np.asarray(jii.window_sums_quantized_planar(Ij, jnp.asarray(radii), levels)),
    )
    exact_j = jnp.moveaxis(jii.window_sums(jnp.moveaxis(Ij, 0, -1), jnp.asarray(radii)), -1, 0)
    np.testing.assert_array_equal(tii.window_sums(It, torch.from_numpy(radii)).numpy(), np.asarray(exact_j))


def test_eigh3x3():
    """Eigenvalues to 1e-5 relative to the spectrum's scale; eigenvector
    frames compared through U diag U^T (their signs are arbitrary) and by
    |v_j . v_t| = 1 for the smallest eigenvector where the gap is clear."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)
    o = np.stack([A[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]).astype(np.float32)
    scale = np.abs(A).max()
    np.testing.assert_allclose(
        teig.eigvals3x3(torch.from_numpy(A)).numpy(), np.asarray(jeig.eigvals3x3(jnp.asarray(A))), atol=1e-5 * scale
    )
    lam_t, V_t = teig.eigh3x3_planar(torch.from_numpy(o))
    lam_j, V_j = jeig.eigh3x3_planar(jnp.asarray(o))
    for a, b in zip(lam_t, lam_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 * scale)

    def recon(lam, V):
        return sum(
            np.asarray(lam[k])[:, None, None] * np.einsum("in,jn->nij", np.stack([np.asarray(c) for c in V[k]]),
                                                          np.stack([np.asarray(c) for c in V[k]]))
            for k in range(3)
        )

    np.testing.assert_allclose(recon(lam_t, V_t), recon(lam_j, V_j), atol=1e-4 * scale)
    v0t = np.stack([c.numpy() for c in V_t[0]])
    v0j = np.stack([np.asarray(c) for c in V_j[0]])
    lj = np.stack([np.asarray(l) for l in lam_j])
    gap = (lj[1] - lj[0]) > 0.05 * scale
    np.testing.assert_allclose(np.abs((v0t * v0j).sum(0))[gap], 1.0, atol=1e-4)


def _moments(depth, proj, ccfg, dtype=torch.float32):
    tproj, tccfg = convert.config_from(proj), convert.config_from(ccfg)
    d = torch.from_numpy(depth).to(dtype)
    pts, valid = tproj.unproject(d)
    radii = torch.clamp(tproj.project_intervals(d, tccfg.world_radius), tccfg.min_image_radius, tccfg.max_image_radius)
    return tii.window_moments_planar(pts.movedim(-1, 0), valid, radii, levels=radius_levels(tccfg))


@pytest.mark.parametrize("name", CASES)
def test_window_moments(name):
    proj, ccfg, depth = _case(name)
    pts, valid = proj.unproject(jnp.asarray(depth))
    radii = jnp.clip(proj.project_intervals(jnp.asarray(depth), ccfg.world_radius),
                     ccfg.min_image_radius, ccfg.max_image_radius)
    levels = radius_levels(convert.config_from(ccfg))
    nj, mj, cj = (np.asarray(x) for x in
                  jii.window_moments_planar(jnp.moveaxis(pts, -1, 0), valid, radii, levels=levels))
    nt, mt, ct = (x.numpy() for x in _moments(depth, proj, ccfg))
    n64, m64, c64 = (x.numpy() for x in _moments(depth, proj, ccfg, torch.float64))
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_allclose(mt, mj, atol=3e-4)
    np.testing.assert_allclose(ct, cj, atol=1e-3)
    # the port is about as close to the float64 moments as JAX is (RMS)

    def rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    assert rms(ct, c64) <= 1.5 * rms(cj, c64) + 1e-7
    assert rms(mt, m64) <= 1.5 * rms(mj, m64) + 1e-7


def _beyond(A, B, key, valid):
    d = np.abs(A[key] - B[key])
    if d.ndim == 3:
        d = d.max(0)
    return float((d > FIELD_TOL[key])[valid].mean())


@pytest.mark.parametrize("name", CASES)
def test_depth_to_cloud(name):
    proj, ccfg, depth = _case(name)
    J = {k: np.asarray(v) for k, v in j_depth_to_cloud(jnp.asarray(depth), proj, ccfg)._asdict().items()}
    tproj, tccfg = convert.config_from(proj), convert.config_from(ccfg)
    T = convert.cloud_to_numpy(t_depth_to_cloud(torch.from_numpy(depth), tproj, tccfg))
    D = convert.cloud_to_numpy(t_depth_to_cloud(torch.from_numpy(depth).double(), tproj, tccfg))
    valid = J["valid"]
    np.testing.assert_array_equal(T["valid"], valid)
    np.testing.assert_allclose(T["p"], J["p"], atol=1e-6)
    for key in FIELD_TOL:
        share = _beyond(J, T, key, valid)
        assert share <= 0.02, (key, share)
        assert _beyond(T, D, key, valid) <= 1.5 * _beyond(J, D, key, valid) + 0.005, key
    has_n_j = (J["n"] ** 2).sum(0) > 0
    has_n_t = (T["n"] ** 2).sum(0) > 0
    assert (has_n_j != has_n_t)[valid].mean() <= 0.01
    assert has_n_t[valid].mean() > 0.5


def test_cloud_transform_and_sensor_offset():
    """`Cloud.transform` and the converter's sensor offset, as in JAX."""
    proj, ccfg, depth = _case("scene")
    offset = np.array(jlie.se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.05, -0.1, 0.2], jnp.float32)))
    J = j_depth_to_cloud(jnp.asarray(depth), proj, ccfg, sensor_offset=jnp.asarray(offset))
    T = t_depth_to_cloud(torch.from_numpy(depth), convert.config_from(proj), convert.config_from(ccfg),
                         sensor_offset=offset)
    plain = t_depth_to_cloud(torch.from_numpy(depth), convert.config_from(proj), convert.config_from(ccfg))
    moved = convert.cloud_to_numpy(plain.transform(torch.from_numpy(offset)))
    T = convert.cloud_to_numpy(T)
    for key in ("p", "n", "evec", "op", "on"):
        np.testing.assert_array_equal(T[key], moved[key])
    valid = np.asarray(J.valid)
    np.testing.assert_allclose(T["p"], np.asarray(J.p), atol=1e-5)
    for key in ("n", "op", "on"):
        assert _beyond({key: np.asarray(getattr(J, key))}, T, key, valid) <= 0.02, key
