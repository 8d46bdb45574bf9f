"""Depth-sensor calibration (counterpart of
``g2o_frontend_tpu/pwn/calibration.py``, the pwn_calibration analog).

The reference estimates a per-pixel multiplicative depth-correction image by
observing flat surfaces (``pwn_utils/pwn_calibration.cpp``). Here:

1. for each calibration frame, fit the dominant plane of the cloud
   (`pwn.planes.extract_planes`),
2. ray-cast that plane to get the IDEAL depth per pixel,
3. accumulate per-pixel ratios ideal/measured; the calibration image is the
   running mean.

The accumulators are float64 tensors on `device`, as the JAX package keeps
them in float64 numpy. `apply` multiplies a raw depth image by the
calibration image.
"""
from __future__ import annotations

import numpy as np
import torch

from .converter import ConverterConfig, depth_to_cloud
from .planes import PlaneExtractorConfig, extract_planes
from .projector import PinholeProjector


class DepthCalibration:
    def __init__(self, projector: PinholeProjector, device="cuda"):
        self.projector = projector
        self.device = torch.device(device)
        H, W = projector.rows, projector.cols
        kw = dict(dtype=torch.float64, device=self.device)
        self._ratio_sum = torch.zeros((H, W), **kw)
        self._count = torch.zeros((H, W), **kw)
        v = torch.arange(H, **kw)[:, None].expand(H, W)
        u = torch.arange(W, **kw)[None, :].expand(H, W)
        self._dirs = torch.stack([(u - projector.cx) / projector.fx, (v - projector.cy) / projector.fy,
                                  torch.ones((H, W), **kw)], -1)

    def add_frame(self, depth, plane=None, converter_config=None, plane_config=None):
        """Accumulate one flat-surface observation; returns the fraction of
        pixels that contributed.

        With `plane=(n, d)` (known geometry, e.g. a measured wall) the
        calibration recovers ABSOLUTE per-pixel multipliers. Without it the
        dominant plane is fitted from the biased data itself, so only
        spatially varying distortion relative to the frame's own plane fit
        is observable (a global depth scale cancels), the reference's
        self-calibration limit."""
        proj = self.projector
        depth = torch.as_tensor(depth, dtype=torch.float32).to(self.device)
        if plane is not None:
            n = torch.as_tensor(np.asarray(plane[0], float), device=self.device)
            d0 = float(plane[1])
        else:
            ccfg = converter_config or ConverterConfig(min_image_radius=3, max_image_radius=8, min_points=12)
            pcfg = plane_config or PlaneExtractorConfig(min_inliers=200)
            ps = extract_planes(depth_to_cloud(depth, proj, ccfg), pcfg)
            if not bool(ps.mask.any()):
                return 0.0
            k = int(torch.argmax(torch.where(ps.mask, ps.n_inliers, -1.0)))
            n = ps.normal[k].double()
            d0 = float(ps.d[k])
        # ideal depth: the ray r(u, v) hits n.p = d0 at z = d0 / (n . dir)
        denom = self._dirs @ n
        ideal = torch.where(denom.abs() > 1e-6, d0 / denom, 0.0)
        meas = depth.double()
        ok = (meas > proj.min_distance) & (ideal > proj.min_distance)
        # only pixels near the plane contribute (a 10% relative gate lets a
        # few-percent sensor bias pass)
        ok &= (ideal - meas).abs() < torch.clamp_min(0.1 * ideal, 0.1)
        self._ratio_sum += torch.where(ok, ideal / meas, 0.0)
        self._count += ok.double()
        return float(ok.double().mean())

    @property
    def calibration_image(self):
        """Per-pixel multiplier (1.0 where never observed), float64."""
        return torch.where(self._count > 0, self._ratio_sum / torch.clamp_min(self._count, 1), 1.0)

    def apply(self, depth):
        return torch.as_tensor(depth).to(self.device) * self.calibration_image.to(torch.float32)

    def save(self, path):
        np.savez_compressed(path, calib=self.calibration_image.cpu().numpy(), count=self._count.cpu().numpy())

    @classmethod
    def load(cls, path, projector, device="cuda"):
        data = np.load(path)
        c = cls(projector, device)
        count = torch.as_tensor(data["count"], dtype=torch.float64, device=c.device)
        c._ratio_sum = torch.as_tensor(data["calib"], dtype=torch.float64, device=c.device) * torch.clamp_min(count, 1)
        c._count = count
        return c
