"""PyTorch port: why the card and the CPU part on `pwn_odometry --conf`,
and the tracker parity tool.

`pwn_odometry --conf g2o_frontend_tpu_torch/conf/pwn_slam_tum.conf` gives
ATE 0.3494 m on the card and 0.3747 m on the CPU. `apps/tracker_parity.py`
on an H100 found the two runs parting at frame 1: on the same inputs
(keyframe 0, the identity guess) the card's aligner counted 107,609
inliers and the CPU's 117,855. The cause is the converter's integral image
(`ops/integral_image.integral_image_planar`, the JAX
`integral_image_planar`): `torch.cumsum` accumulates float32 in float64 on
the CPU and in float32 on the card, as XLA does, and over a 480x640 image
the float32 prefix sums of p p^T round away digits that the conf's 3-6 px
windows need. The card keeps the reference's float32 arithmetic.

These CPU tests pin it with a cumsum that accumulates in its input's
dtype (a Hillis-Steele scan, in a parallel scan's order, as the card's):
- the conf's alignment of TUM frame 1 against frame 0 counts 117,855
  inliers with the CPU's cumsum (held within 0.5%) and 99,212 with the
  float32 one, fewer than 0.9x (the card's own scan order gave 107,609);
  with the table in float64 283,272, more than 2x;
- the parity tool, CPU against CPU over 3 frames: no frame parts.
"""
import os

import numpy as np
import torch
import torch.nn.functional as F

from g2o_frontend_tpu_torch.apps import tracker_parity
from g2o_frontend_tpu_torch.io import tum
from g2o_frontend_tpu_torch.ops import integral_image
from g2o_frontend_tpu_torch.pwn import converter
from g2o_frontend_tpu_torch.pwn.aligner import align
from g2o_frontend_tpu_torch.pwn.pipeline import load_pipeline

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = os.path.join(REPO, "eval_out", "tum_seq")
CONF = os.path.join(REPO, "g2o_frontend_tpu_torch", "conf", "pwn_slam_tum.conf")


def _cumsum_in_input_dtype(x, dim, *, dtype=None):
    """An inclusive scan that accumulates in its input's dtype (after the
    cast `dtype` asks for), in a parallel scan's order."""
    x = x if dtype is None else x.to(dtype)
    n, k = x.shape[dim], 1
    while k < n:
        x = x + torch.cat([torch.zeros_like(x.narrow(dim, 0, k)), x.narrow(dim, 0, n - k)], dim)
        k *= 2
    return x


def _float64_table(x):
    return F.pad(torch.cumsum(torch.cumsum(x.double(), 1), 2), (1, 0, 1, 0))


def _float32_moments(*args, **kwargs):
    return tuple(t.float() for t in integral_image.window_moments_planar(*args, **kwargs))


def _depths(n):
    index = tum.read_depth_index(SEQ)[:n]
    return [torch.from_numpy(tum.load_depth_png_raw(os.path.join(SEQ, rel)).astype(np.float32) * np.float32(1 / 5000))
            for _, rel in index]


def test_conf_frame_1_inliers_follow_the_integral_image_precision(monkeypatch):
    pipe = load_pipeline(CONF)
    proj, ccfg, acfg = pipe.scaled_projector(), pipe.converter_config, pipe.aligner_config
    d0, d1 = _depths(2)

    def inliers():
        ref, cur = converter.depth_to_cloud(d0, proj, ccfg), converter.depth_to_cloud(d1, proj, ccfg)
        return int(align(ref, cur, proj, np.eye(4, dtype=np.float32), acfg).inliers)

    cpu = inliers()  # the CPU's cumsum: a float32 table, float64 accumulation
    assert abs(cpu - 117855) <= 0.005 * 117855
    with monkeypatch.context() as m:
        m.setattr(torch, "cumsum", _cumsum_in_input_dtype)
        assert inliers() < 0.9 * cpu  # float32 accumulation, as on the card: 99,212
    monkeypatch.setattr(integral_image, "integral_image_planar", _float64_table)
    monkeypatch.setattr(converter, "window_moments_planar", _float32_moments)
    assert inliers() > 2 * cpu  # a float64 table: 283,272


def test_parity_tool_cpu_against_cpu(tmp_path):
    r = tracker_parity.run([SEQ, "--conf", CONF, "--device", "cpu", "--against", "cpu", "--max-frames", "3",
                            "--out", str(tmp_path / "report.json")])
    assert r["frames"] == 3 and r["keyframes"][0] == r["keyframes"][1]
    assert r["first_inliers_differ"] is None and r["first_keyframe_differs"] is None and r["final_dt"] == 0.0
    assert (tmp_path / "report.json").stat().st_size > 0
