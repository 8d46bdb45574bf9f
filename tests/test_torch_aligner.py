"""PyTorch port: the aligner against the JAX package.

Both packages align the same clouds: the JAX converter's output on the
`_scene` of tests/test_fused_aligner.py (96x128), carried to the port by
`convert.cloud_from_numpy`, so converter noise does not blur the aligner
comparison. The port runs its plain PyTorch system on the CPU (the CUDA
kernel is held against the same plain version on the card by
chip_smoke.py); JAX runs on the CPU, its Pallas kernel in interpret mode.

Tolerances:
- 29 sums against JAX's `_correspondences_gather` + `_linearize_planar` at
  three fixed invT: inliers equal (no boundary pixel moved on these inputs);
  H, b and chi2 within rtol 1e-4 of their norm (observed ~3e-7);
- against JAX's Pallas `fused_linearize` (banded, bf16 reference): the
  tolerances of test_system_matches_gather_twin: inliers >= 0.97x, H within
  5%, b within 10%;
- `align` end to end against JAX's gather association: T within rtol 1e-4,
  atol 1e-5; mean, omega and the eigenratios within rtol 1e-3; inliers
  within 2; chi2 within rtol 1e-3; valid equal; band_coverage 1.0;
- priors: H, b within rtol 1e-4; z-buffer path: inliers equal, H/b/chi2
  within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.ops import pallas_aligner as jpa
from g2o_frontend_tpu.pwn import aligner as ja
from g2o_frontend_tpu.pwn.converter import ConverterConfig, depth_to_cloud
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.ops import fused_aligner as tfa
from g2o_frontend_tpu_torch.pwn import aligner as ta

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    proj = default_projector(H=96, W=128)
    ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
    xi = jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.008, 0.006], jnp.float32)
    T = np.asarray(jlie.se3_v2t(xi))
    ref = depth_to_cloud(render_planes_depth(np.eye(4), proj), proj, ccfg)
    cur = depth_to_cloud(render_planes_depth(T, proj), proj, ccfg)

    def port(c):
        return convert.cloud_from_numpy({k: np.asarray(v) for k, v in c._asdict().items()}, device="cpu")

    return dict(proj=proj, ref=ref, cur=cur, T=T, tproj=convert.config_from(proj), tref=port(ref), tcur=port(cur))


def _invTs(T):
    perturb = np.asarray(jlie.se3_exp(jnp.asarray([0.03, 0.0, -0.02, 0.0, 0.03, 0.0], jnp.float32)))
    inv = np.linalg.inv(T)
    return {"identity": np.eye(4), "ground_truth": inv, "perturbed": perturb @ inv}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("pose", ["identity", "ground_truth", "perturbed"])
def test_sums_match_jax_gather_twin(scene, pose):
    cfg = ja.AlignerConfig()
    invT = _invTs(scene["T"])[pose].astype(np.float32)
    m, rp, rn = ja._correspondences_gather(scene["ref"], scene["cur"], jnp.asarray(invT), scene["proj"], cfg)
    Hj, bj, cj, ij = ja._linearize_planar(m, rp, rn, scene["cur"], jnp.asarray(invT), cfg)

    tcfg = convert.config_from(cfg)
    params = tfa.params_from_invT(torch.from_numpy(invT))
    sums = tfa.fused_system(tfa.pack_cur(scene["tcur"]), tfa.pack_ref(scene["tref"]), params, scene["tproj"], tcfg)
    Ht, bt, ct, it = tfa.unpack_sums(sums)
    # the Cloud-level twins give the same system
    Ht2, bt2, ct2, it2 = ta._linearize_planar(
        *ta._correspondences_gather(scene["tref"], scene["tcur"], torch.from_numpy(invT), scene["tproj"], tcfg),
        scene["tcur"], torch.from_numpy(invT), tcfg,
    )
    np.testing.assert_allclose(Ht2.numpy(), Ht.numpy(), rtol=1e-6, atol=1e-3)
    assert int(it2) == int(it)

    assert int(it) == int(ij) > 1000
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(bt, bj) < 1e-4
    assert abs(float(ct) - float(cj)) <= 1e-4 * abs(float(cj))


@pytest.mark.parametrize("case", ["non_robust", "sensor_offset"])
def test_sums_other_configs_match_jax(scene, case):
    """The non-robust kernel (chi2 gate instead of the clamp), and clouds
    made with a sensor offset, whose reference points are fetched as stored
    (the TPU kernel rebuilt them from depth), against the JAX gather twin."""
    proj = scene["proj"]
    cfg = ja.AlignerConfig(robust_kernel=case != "non_robust", inlier_max_chi2=9e3 if case == "sensor_offset" else 2.0)
    ref, cur, tref, tcur = scene["ref"], scene["cur"], scene["tref"], scene["tcur"]
    if case == "sensor_offset":
        offset = np.asarray(jlie.se3_exp(jnp.asarray([0.05, 0.02, -0.03, 0.02, -0.04, 0.03], jnp.float32)))
        ccfg = ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
        ref, cur = (depth_to_cloud(render_planes_depth(T, proj), proj, ccfg, sensor_offset=jnp.asarray(offset))
                    for T in (np.eye(4), scene["T"]))
        tref, tcur = (convert.cloud_from_numpy({k: np.asarray(v) for k, v in c._asdict().items()}, device="cpu")
                      for c in (ref, cur))
    invT = _invTs(scene["T"])["perturbed"].astype(np.float32)
    m, rp, rn = ja._correspondences_gather(ref, cur, jnp.asarray(invT), proj, cfg)
    Hj, bj, cj, ij = ja._linearize_planar(m, rp, rn, cur, jnp.asarray(invT), cfg)
    Ht, bt, ct, it = tfa.unpack_sums(
        tfa.fused_system(tfa.pack_cur(tcur), tfa.pack_ref(tref), tfa.params_from_invT(torch.from_numpy(invT)),
                         scene["tproj"], convert.config_from(cfg))
    )
    assert int(it) == int(ij) > 500
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(bt, bj) < 1e-4
    assert abs(float(ct) - float(cj)) <= 1e-4 * abs(float(cj))


def test_sums_vs_pallas_fused_interpret(scene):
    """The TPU kernel's banded window loses a few correspondences that the
    exact gather keeps, so the Pallas sums only approach the port's."""
    cfg = ja.AlignerConfig()
    proj = scene["proj"]
    invT = jnp.eye(4, dtype=jnp.float32)
    cur_p, ref_p = jpa.prepare_fused_inputs(
        scene["ref"], scene["cur"], TR=cfg.tile_rows, TC=cfg.tile_cols, DV=cfg.band_dv, DU=cfg.band_du
    )
    sums = jpa.fused_linearize(
        cur_p, ref_p, jpa.params_from_invT(invT),
        H=proj.rows, W=proj.cols, TR=cfg.tile_rows, TC=cfg.tile_cols, DV=cfg.band_dv, DU=cfg.band_du,
        fx=proj.fx, fy=proj.fy, cx=proj.cx, cy=proj.cy, min_d=proj.min_distance, max_d=proj.max_distance,
        nthr=cfg.inlier_normal_angular_threshold, dthr2=cfg.inlier_distance_threshold**2,
        cthr=cfg.flat_curvature_threshold, rthr=cfg.inlier_curvature_ratio_threshold,
        max_chi2=cfg.inlier_max_chi2, robust=cfg.robust_kernel, interpret=jax.default_backend() != "tpu",
    )
    Hf, bf, _, inlf = jpa.unpack_sums(sums)
    params = tfa.params_from_invT(torch.eye(4))
    Ht, bt, _, it = tfa.unpack_sums(
        tfa.fused_system(tfa.pack_cur(scene["tcur"]), tfa.pack_ref(scene["tref"]), params, scene["tproj"],
                         convert.config_from(cfg))
    )
    assert int(inlf) >= 0.97 * int(it)
    assert _rel(Hf, Ht) < 0.05
    assert _rel(bf, bt) < 0.1


def test_align_end_to_end(scene):
    cfg = ja.AlignerConfig(outer_iterations=6, association="gather")
    rj = ja.align(scene["ref"], scene["cur"], scene["proj"], config=cfg)
    rt = ta.align(scene["tref"], scene["tcur"], scene["tproj"], config=convert.config_from(cfg))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), rtol=1e-4, atol=1e-5)
    for field in ("mean", "omega", "translational_ratio", "rotational_ratio"):
        np.testing.assert_allclose(getattr(rt, field).numpy(), np.asarray(getattr(rj, field)), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(getattr(rj, field))).max()), err_msg=field)
    assert abs(int(rt.inliers) - int(rj.inliers)) <= 2
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-3)
    assert bool(rt.valid) == bool(rj.valid)
    assert float(rt.band_coverage) == 1.0
    assert rt.inliers.dtype == torch.int32 and rt.valid.dtype == torch.bool
    assert np.linalg.norm(rt.T.numpy()[:3, 3] - scene["T"][:3, 3]) < 5e-3


def test_align_from_guess_and_associations_agree(scene):
    """An initial guess is honoured, and "auto", "fused" and "gather" are one
    path on CPU tensors (the plain system)."""
    guess = torch.from_numpy(scene["T"].astype(np.float32))
    results = [
        ta.align(scene["tref"], scene["tcur"], scene["tproj"], guess, ta.AlignerConfig(outer_iterations=2,
                                                                                       association=a))
        for a in ("auto", "fused", "gather")
    ]
    for r in results[1:]:
        np.testing.assert_array_equal(r.T.numpy(), results[0].T.numpy())
    assert np.linalg.norm(results[0].T.numpy()[:3, 3] - scene["T"][:3, 3]) < 5e-3
    with pytest.raises(ValueError):
        ta.align(scene["tref"], scene["tcur"], scene["tproj"], config=ta.AlignerConfig(association="banded"))


def test_prior_system_and_align_with_prior(scene):
    rng = np.random.default_rng(3)
    ref_T = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(scale=0.2, size=6), jnp.float32)))
    mean = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(scale=0.1, size=6), jnp.float32)))
    A = rng.normal(size=(6, 6)).astype(np.float32)
    info = A @ A.T + 6 * np.eye(6, dtype=np.float32)
    invT = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(scale=0.05, size=6), jnp.float32)))
    pj = ja.absolute_prior(jnp.asarray(ref_T), jnp.asarray(mean), jnp.asarray(info))
    pt = ta.absolute_prior(*(torch.from_numpy(np.array(x)) for x in (ref_T, mean, info)))
    Hj, bj = ja._prior_system(pj, jnp.asarray(invT))
    Ht, bt = ta._prior_system(pt, torch.from_numpy(invT))
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(bt, bj) < 1e-4

    cfg = ja.AlignerConfig(outer_iterations=3, association="gather")
    prior = ja.SE3Prior(jnp.asarray(mean), jnp.asarray(info * 1e4))
    rj = ja.align(scene["ref"], scene["cur"], scene["proj"], config=cfg, priors=prior)
    rt = ta.align(scene["tref"], scene["tcur"], scene["tproj"], config=convert.config_from(cfg),
                  priors=ta.SE3Prior(torch.from_numpy(mean), torch.from_numpy(info * 1e4)))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), rtol=1e-4, atol=1e-5)


def test_zbuffer_association(scene):
    cfg = ja.AlignerConfig(association="zbuffer")
    tcfg = convert.config_from(cfg)
    invT = np.linalg.inv(scene["T"]).astype(np.float32)
    m, rp, rn = ja._correspondences(scene["ref"], scene["cur"], jnp.asarray(invT), scene["proj"], cfg)
    Hj, bj, cj, ij = ja._linearize(m, rp, rn, scene["cur"], jnp.asarray(invT), cfg)
    mt, rpt, rnt = ta._correspondences(scene["tref"], scene["tcur"], torch.from_numpy(invT), scene["tproj"], tcfg)
    Ht, bt, ct, it = ta._linearize(mt, rpt, rnt, scene["tcur"], torch.from_numpy(invT), tcfg)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(m))
    assert int(it) == int(ij) > 1000
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(bt, bj) < 1e-4
    assert abs(float(ct) - float(cj)) <= 1e-4 * abs(float(cj))
    res = ta.align(scene["tref"], scene["tcur"], scene["tproj"], config=ta.AlignerConfig(outer_iterations=4,
                                                                                          association="zbuffer"))
    assert np.linalg.norm(res.T.numpy()[:3, 3] - scene["T"][:3, 3]) < 5e-3
