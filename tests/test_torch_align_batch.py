"""PyTorch port: batched candidate alignment (kernel 2's path), the matcher,
and the z-buffer linearizer (kernel 3's plain version) against the JAX
package.

Clouds are made by the JAX converter and carried to the port with
`convert.cloud_from_numpy`, so converter noise does not blur the
comparisons. The port runs its plain PyTorch versions on the CPU (the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py); JAX runs on the CPU, its Pallas kernels in interpret mode.

Tolerances:
- `align_batch` against JAX's `align_batch(association="gather")` on the
  tests/test_batched_closer.py fixture (9 candidates, 96x128): T within
  atol 1e-5, aligner inliers equal; against the port's serial `align`: T
  within atol 1e-6, every field of the result equal in shape;
- the plain batch system against JAX's Pallas `fused_linearize_batch` in
  interpret mode (K = 2, banded bf16 reference): the band tolerances of
  tests/test_torch_aligner.py, inliers >= 0.97x, H within 5%, b within 10%;
- `match_clouds` / `match_clouds_batch`: image nonzeros, inliers and
  outliers equal to JAX's, reprojection distance within rtol 1e-4;
  `make_thumbnails`: the same pixels hit, depths within 8 cm and equal on
  80% of pixels, normals equal on 90% (ties on thumbnail pixel
  boundaries; see the test);
- the plain linearizer against JAX's `_linearize` (z-buffer association, a
  perturbed pose, robust and non-robust): inliers equal, chi2 within rtol
  1e-4, H and b within rtol 2e-4 of their norms; against
  `linearize_pallas(interpret=True)`: the same tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ops import pallas_aligner as jpa
from g2o_frontend_tpu.ops import pallas_linearizer as jpl
from g2o_frontend_tpu.pwn import aligner as ja
from g2o_frontend_tpu.pwn.converter import ConverterConfig, depth_to_cloud
from g2o_frontend_tpu.slam import pwn_matcher as jm
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.ops import fused_aligner as tfa
from g2o_frontend_tpu_torch.ops import linearizer as tlin
from g2o_frontend_tpu_torch.pwn import aligner as ta
from g2o_frontend_tpu_torch.slam import pwn_matcher as tm

torch.set_num_threads(1)


def _port(c):
    return convert.cloud_from_numpy({k: np.asarray(v) for k, v in c._asdict().items()}, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def closer_scene():
    """The fixture of tests/test_batched_closer.py: 9 clouds at random poses
    around the identity; cloud 0 is the current one."""
    proj = default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=2, max_image_radius=6, min_points=10)
    rng = np.random.default_rng(3)
    clouds, poses = [], []
    for _ in range(9):
        xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.03, 3)])
        T = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
        clouds.append(depth_to_cloud(render_planes_depth(T, proj), proj, ccfg))
        poses.append(T)
    guesses = np.stack([np.linalg.inv(np.linalg.inv(poses[0]) @ poses[k]) for k in range(1, 9)]).astype(np.float32)
    acfg = ja.AlignerConfig(outer_iterations=4, association="gather")
    tclouds = [_port(c) for c in clouds]
    return dict(
        proj=proj, acfg=acfg, cur=clouds[0], refs=clouds[1:], guesses=guesses, tproj=convert.config_from(proj),
        tacfg=convert.config_from(acfg), tcur=tclouds[0], trefs=tclouds[1:],
    )


def test_align_batch_matches_jax(closer_scene):
    s = closer_scene
    rj = ja.align_batch(jm.stack_clouds(s["refs"]), s["cur"], s["proj"], jnp.asarray(s["guesses"]), s["acfg"])
    rt = ta.align_batch(tm.stack_clouds(s["trefs"]), s["tcur"], s["tproj"], torch.from_numpy(s["guesses"]),
                        s["tacfg"])
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-5)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))


def test_align_batch_matches_serial_align(closer_scene):
    s = closer_scene
    rb = ta.align_batch(tm.stack_clouds(s["trefs"]), s["tcur"], s["tproj"], torch.from_numpy(s["guesses"]),
                        s["tacfg"])
    for k, ref in enumerate(s["trefs"]):
        r1 = ta.align(ref, s["tcur"], s["tproj"], torch.from_numpy(s["guesses"][k]), s["tacfg"])
        for field in ta.AlignResult._fields:
            assert getattr(rb, field)[k].shape == getattr(r1, field).shape, field
        np.testing.assert_allclose(rb.T[k].numpy(), r1.T.numpy(), atol=1e-6)
        assert int(rb.inliers[k]) == int(r1.inliers)


def test_batch_system_vs_pallas_interpret(pair_scene):
    """K = 2 candidates, the pair's reference and the same room seen from 1
    cm / 0.6 deg away, each at the pose that puts the current camera at the
    identity (away from the optimum, where b does not nearly cancel): the
    port's plain batch system against the TPU batch kernel run in interpret
    mode, whose banded window drops a few correspondences that the exact
    gather keeps."""
    s = pair_scene
    cfg = ja.AlignerConfig()
    proj = s["proj"]
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    P = np.asarray(jlie.se3_exp(jnp.asarray([0.01, 0.0, 0.0, 0.0, 0.01, 0.0], jnp.float32)))
    refs = [s["ref"], depth_to_cloud(render_planes_depth(P, proj), proj, ccfg)]
    invTs = np.stack([np.eye(4), P]).astype(np.float32)
    cur_p, ref_ps = jpa.prepare_fused_batch(jm.stack_clouds(refs), s["cur"], TR=cfg.tile_rows, TC=cfg.tile_cols,
                                           DV=cfg.band_dv, DU=cfg.band_du)
    prms = jnp.concatenate([jpa.params_from_invT(jnp.asarray(t)) for t in invTs], 0)
    sums_j = jpa.fused_linearize_batch(
        cur_p, ref_ps, prms,
        H=proj.rows, W=proj.cols, TR=cfg.tile_rows, TC=cfg.tile_cols, DV=cfg.band_dv, DU=cfg.band_du,
        fx=proj.fx, fy=proj.fy, cx=proj.cx, cy=proj.cy, min_d=proj.min_distance, max_d=proj.max_distance,
        nthr=cfg.inlier_normal_angular_threshold, dthr2=cfg.inlier_distance_threshold**2,
        cthr=cfg.flat_curvature_threshold, rthr=cfg.inlier_curvature_ratio_threshold,
        max_chi2=cfg.inlier_max_chi2, robust=cfg.robust_kernel, interpret=jax.default_backend() != "tpu",
    )
    tcfg = convert.config_from(cfg)
    tables = tfa.pack_ref(tm.stack_clouds([_port(c) for c in refs]))
    assert tuple(tables.shape) == (2, proj.rows * proj.cols, tfa.C_REF)
    params = tfa.params_from_invT(torch.from_numpy(invTs))
    cur_packed = tfa.pack_cur(s["tcur"])
    sums_t = tfa.fused_system_batch(cur_packed, tables, params, s["tproj"], tcfg)
    assert tuple(sums_t.shape) == (2, tfa.N_SUMS)
    for k in range(2):
        Hj, bj, _, ij = jpa.unpack_sums(sums_j[k])
        Ht, bt, _, it = tfa.unpack_sums(sums_t[k])
        # row k of the batch is the single system of candidate k
        single = tfa.fused_system(cur_packed, tables[k], params[k], s["tproj"], tcfg)
        np.testing.assert_array_equal(sums_t[k].numpy(), single.numpy())
        assert int(ij) >= 0.97 * int(it) > 1000
        assert _rel(Hj, Ht) < 0.05
        assert _rel(bj, bt) < 0.1


def test_match_clouds_batch_matches_jax(closer_scene):
    s = closer_scene
    refs, guesses = s["refs"][:3], s["guesses"][:3]
    jb = jm.match_clouds_batch(jm.stack_clouds(refs), s["cur"], s["proj"], jnp.asarray(guesses), s["acfg"])
    tb = tm.match_clouds_batch(tm.stack_clouds(s["trefs"][:3]), s["tcur"], s["tproj"], torch.from_numpy(guesses),
                               s["tacfg"])
    for field in ("image_nonzeros", "image_inliers", "image_outliers", "cloud_inliers"):
        np.testing.assert_array_equal(getattr(tb, field).numpy(), np.asarray(getattr(jb, field)), err_msg=field)
    assert (tb.image_nonzeros.numpy() > 5000).all()
    np.testing.assert_allclose(tb.reprojection_distance.numpy(), np.asarray(jb.reprojection_distance), rtol=1e-4)
    np.testing.assert_array_equal(tb.information.numpy(), np.asarray(jb.information))
    j1 = jm.match_clouds(refs[0], s["cur"], s["proj"], jnp.asarray(guesses[0]), s["acfg"])
    t1 = tm.match_clouds(s["trefs"][0], s["tcur"], s["tproj"], torch.from_numpy(guesses[0]), s["tacfg"])
    for field in ("image_nonzeros", "image_inliers", "image_outliers"):
        assert int(getattr(t1, field)) == int(getattr(j1, field)) == int(getattr(tb, field)[0]), field
    # the closer's depth + normal thumbnails. At scale 4 a quarter of the
    # full-resolution points project exactly onto a thumbnail pixel
    # boundary (u / 4 = k + 0.5), where float32 rounding picks the
    # neighbour: the winner of such a pixel may be its neighbour's point
    dj, nj = (np.asarray(x) for x in jm.make_thumbnails(s["cur"], s["proj"], scale=4))
    dt, nt = (x.numpy() for x in tm.make_thumbnails(s["tcur"], s["tproj"], scale=4))
    assert dt.shape == dj.shape == (24, 32) and nt.dtype == np.uint8
    np.testing.assert_array_equal(dt > 0, dj > 0)
    assert np.abs(dt - dj).max() < 0.08 and (dt == dj).mean() > 0.8
    assert (nt == nj).all(-1).mean() > 0.9


@pytest.fixture(scope="module")
def pair_scene():
    """The pair of tests/test_torch_aligner.py: the room at the identity and
    after a small known motion T, with a perturbed pose near T^-1."""
    proj = default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    T = np.asarray(jlie.se3_v2t(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.008, 0.006], jnp.float32)))
    ref = depth_to_cloud(render_planes_depth(np.eye(4), proj), proj, ccfg)
    cur = depth_to_cloud(render_planes_depth(T, proj), proj, ccfg)
    perturb = np.asarray(jlie.se3_exp(jnp.asarray([0.01, 0.0, -0.01, 0.0, 0.01, 0.0], jnp.float32)))
    invT = (perturb @ np.linalg.inv(T)).astype(np.float32)
    return dict(proj=proj, ref=ref, cur=cur, T=T, invT=invT, tproj=convert.config_from(proj), tcur=_port(cur))


def _jax_zbuffer_planes(s, cfg):
    m, rp, rn = ja._correspondences(s["ref"], s["cur"], jnp.asarray(s["invT"]), s["proj"], cfg)
    return m, rp, rn


@pytest.mark.parametrize("robust", [True, False], ids=["robust", "non_robust"])
def test_linearizer_matches_jax_linearize(pair_scene, robust):
    """Kernel 3's plain version on the JAX z-buffer association's planes,
    remapped by the port, against JAX's `_linearize`; the non-robust case
    drops correspondences above a chi2 gate that binds (max_chi2 = 0.1
    keeps about half of them)."""
    s = pair_scene
    cfg = ja.AlignerConfig(association="zbuffer", robust_kernel=robust, inlier_max_chi2=9e3 if robust else 0.1)
    tcfg = convert.config_from(cfg)
    m, rp, rn = _jax_zbuffer_planes(s, cfg)
    Hj, bj, cj, ij = ja._linearize(m, rp, rn, s["cur"], jnp.asarray(s["invT"]), cfg)
    invT = torch.from_numpy(s["invT"])
    p, n = ta._remap(torch.from_numpy(np.asarray(rp)), torch.from_numpy(np.asarray(rn)), invT)
    mask = torch.from_numpy(np.asarray(m))
    sums = tlin.linearize_system(mask, p, n, tfa.pack_cur(s["tcur"]), tcfg)
    np.testing.assert_array_equal(sums.numpy(), tlin.linearize_system_reference(mask, p, n, tfa.pack_cur(s["tcur"]),
                                                                               tcfg).numpy())
    Ht, bt, ct, it = tfa.unpack_sums(sums)
    assert int(it) == int(ij) > 1000
    assert robust or int(it) < 0.8 * int(m.sum())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    assert _rel(Ht, Hj) < 2e-4
    assert _rel(bt, bj) < 2e-4


def test_linearizer_vs_pallas_interpret(pair_scene):
    """Against the TPU linearizer kernel in interpret mode, which takes the
    remapped planes in the trailing layout (robust only)."""
    s = pair_scene
    cfg = ja.AlignerConfig(association="zbuffer")
    m, rp, rn = _jax_zbuffer_planes(s, cfg)
    invT = jnp.asarray(s["invT"])
    R, t = invT[:3, :3], invT[:3, 3]
    rp_cur = jnp.einsum("ij,hwj->hwi", R, rp) + t
    rn_cur = jnp.einsum("ij,hwj->hwi", R, rn)
    cur = s["cur"]
    packed = jpl.pack_inputs(np.asarray(m), rp_cur, rn_cur, cur.points, cur.normals, np.asarray(cur.omega_p),
                             np.asarray(cur.omega_n))
    Hj, bj, cj, ij = jpl.linearize_pallas(packed, cfg.inlier_max_chi2, interpret=jax.default_backend() != "tpu")
    p, n = ta._remap(torch.from_numpy(np.asarray(rp)), torch.from_numpy(np.asarray(rn)), torch.from_numpy(s["invT"]))
    Ht, bt, ct, it = tfa.unpack_sums(
        tlin.linearize_system_reference(torch.from_numpy(np.asarray(m)), p, n, tfa.pack_cur(s["tcur"]),
                                        convert.config_from(cfg))
    )
    assert int(it) == int(ij)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)
    assert _rel(Ht, Hj) < 2e-4
    assert _rel(bt, bj) < 2e-4


def test_align_batch_zbuffer_is_serial(closer_scene):
    """The z-buffer association has no batch kernel: align_batch runs K
    serial `align` calls, each through the linearizer."""
    s = closer_scene
    cfg = dataclasses.replace(s["tacfg"], association="zbuffer", outer_iterations=2)
    rb = ta.align_batch(tm.stack_clouds(s["trefs"][:2]), s["tcur"], s["tproj"], torch.from_numpy(s["guesses"][:2]),
                        cfg)
    for k in range(2):
        r1 = ta.align(s["trefs"][k], s["tcur"], s["tproj"], torch.from_numpy(s["guesses"][k]), cfg)
        np.testing.assert_array_equal(rb.T[k].numpy(), r1.T.numpy())


def test_wrappers_reject_bad_inputs(closer_scene):
    s = closer_scene
    cur_packed = tfa.pack_cur(s["tcur"])
    tables = tfa.pack_ref(tm.stack_clouds(s["trefs"][:2]))
    params = tfa.params_from_invT(torch.from_numpy(s["guesses"][:2]))
    with pytest.raises(ValueError):
        tfa._check(cur_packed, tables, params[:1], 96, 128, K=2)
    with pytest.raises(ValueError):
        tfa._check(cur_packed, tables.double(), params, 96, 128, K=2)
    mask = torch.ones(96, 128, dtype=torch.bool)
    planes = torch.zeros(3, 96, 128)
    with pytest.raises(ValueError):
        tlin._check(mask[:, :64], planes, planes, cur_packed)
    with pytest.raises(ValueError):
        tlin._check(mask, planes.double(), planes, cur_packed)
