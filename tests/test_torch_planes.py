"""PyTorch port: plane extraction and depth calibration, against the JAX
package.

Both packages run on the CPU. Plane extraction sees the same clouds (the
JAX converter's, carried into the port by `convert`); the calibration runs
each package's own converter, as each package's `add_frame` does.

Tolerances:
- `extract_planes`: mask and inlier counts equal; normals, d and centroids
  within rtol 1e-5 and atol 1e-5; on the synthetic room from two poses, on
  a noisy view and on a 120x160 frame of eval_out/tum_seq. The refits sum
  the inliers' covariance in another float32 order than JAX's einsum: on
  the noisy view's 350-inlier floor hypothesis d (0.964) differs by 1.7e-5;
- `planes_to_array`: equal to the PlaneSet's fields (exact);
- `DepthCalibration`: the per-frame contributing fraction equal, the
  calibration image within atol 1e-5, with a known plane and with the
  plane fitted from the frame; the saved file loads in the JAX package.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_frontend_tpu.io.tum import load_depth_png
from g2o_frontend_tpu.pwn import calibration as jcal
from g2o_frontend_tpu.pwn import planes as jpl
from g2o_frontend_tpu.pwn.converter import ConverterConfig as JConverterConfig
from g2o_frontend_tpu.pwn.converter import depth_to_cloud as jdepth_to_cloud
from g2o_frontend_tpu.pwn.projector import PinholeProjector as JPinholeProjector
from g2o_frontend_tpu.utils import lie as jlie
from g2o_frontend_tpu.utils.synth import default_projector, render_planes_depth
from g2o_frontend_tpu_torch import convert
from g2o_frontend_tpu_torch.pwn import calibration as tcal
from g2o_frontend_tpu_torch.pwn import planes as tpl

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEQ = REPO / "eval_out" / "tum_seq"
ROOM = default_projector(H=96, W=128)
TUM = JPinholeProjector(rows=120, cols=160, fx=525 / 4, fy=525 / 4, cx=319.5 / 4, cy=239.5 / 4, min_distance=0.3,
                        max_distance=6.0)
CCFG = JConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)


def _tum_depth(k):
    lines = [ln.split()[1] for ln in (SEQ / "depth.txt").read_text().splitlines() if ln and not ln.startswith("#")]
    return np.ascontiguousarray(load_depth_png(str(SEQ / lines[k]))[::4, ::4])


def _scene(case):
    """(JAX projector, depth image) of a case."""
    if case == "room":
        return ROOM, np.asarray(render_planes_depth(np.eye(4), ROOM))
    if case == "room_moved":
        T = np.asarray(jlie.se3_exp(jnp.asarray([0.2, -0.1, 0.15, 0.05, 0.1, -0.08], jnp.float32)))
        return ROOM, np.asarray(render_planes_depth(T, ROOM))
    if case == "room_noisy":
        d = np.asarray(render_planes_depth(np.eye(4), ROOM))
        return ROOM, (d * (1 + 0.003 * np.random.default_rng(7).normal(size=d.shape))).astype(np.float32)
    return TUM, _tum_depth(40)


@pytest.mark.parametrize("min_inliers", [200, 50])
@pytest.mark.parametrize("case", ["room", "room_moved", "room_noisy", "tum"])
def test_extract_planes_matches_jax(case, min_inliers):
    proj, depth = _scene(case)
    jc = jdepth_to_cloud(jnp.asarray(depth), proj, CCFG)
    tc = convert.cloud_from_numpy({k: np.asarray(v) for k, v in jc._asdict().items()}, device="cpu")
    psj = jpl.extract_planes(jc, jpl.PlaneExtractorConfig(min_inliers=min_inliers))
    pst = tpl.extract_planes(tc, tpl.PlaneExtractorConfig(min_inliers=min_inliers))
    np.testing.assert_array_equal(pst.mask.numpy(), np.asarray(psj.mask))
    np.testing.assert_array_equal(pst.n_inliers.numpy(), np.asarray(psj.n_inliers))
    for name in ("normal", "d", "centroid"):
        np.testing.assert_allclose(getattr(pst, name).numpy(), np.asarray(getattr(psj, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert int(pst.mask.sum()) >= 2
    arr, mask = tpl.planes_to_array(pst)
    np.testing.assert_array_equal(arr.numpy(), np.concatenate([pst.normal.numpy(), pst.d.numpy()[:, None]], -1))
    assert mask is pst.mask


@pytest.mark.parametrize("known_plane", [False, True])
def test_depth_calibration_matches_jax(tmp_path, known_plane):
    rng = np.random.default_rng(5)
    cj = jcal.DepthCalibration(ROOM)
    ct = tcal.DepthCalibration(convert.config_from(ROOM), device="cpu")
    bias = 1.0 + 0.02 * np.linspace(-1, 1, ROOM.cols, dtype=np.float32)[None, :]  # a lateral depth distortion
    for k in range(3):
        T = np.asarray(jlie.se3_exp(jnp.asarray(0.03 * rng.normal(size=6), jnp.float32)))
        depth = (np.asarray(render_planes_depth(T, ROOM)) * bias).astype(np.float32)
        plane = None
        if known_plane:  # the back wall z = 2.5 in the room frame, seen from T
            n_w = np.array([0.0, 0.0, 1.0])
            plane = (T[:3, :3].T @ n_w, 2.5 - n_w @ T[:3, 3])
        fj = cj.add_frame(depth, plane=plane)
        ft = ct.add_frame(torch.from_numpy(depth), plane=plane)
        assert ft == pytest.approx(fj, abs=1e-12) and ft > 0.05
    np.testing.assert_allclose(ct.calibration_image.numpy(), cj.calibration_image, atol=1e-5)
    depth = torch.from_numpy(np.asarray(render_planes_depth(np.eye(4), ROOM)))
    np.testing.assert_allclose(ct.apply(depth).numpy(), np.asarray(cj.apply(depth.numpy())), atol=1e-5)
    ct.save(tmp_path / "calib.npz")
    back = jcal.DepthCalibration.load(tmp_path / "calib.npz", ROOM)
    np.testing.assert_allclose(back.calibration_image, ct.calibration_image.numpy(), atol=1e-12)
    again = tcal.DepthCalibration.load(tmp_path / "calib.npz", convert.config_from(ROOM), device="cpu")
    np.testing.assert_allclose(again.calibration_image.numpy(), ct.calibration_image.numpy(), atol=1e-12)
