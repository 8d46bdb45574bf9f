"""Depth image -> point-with-normal cloud (counterpart of
``g2o_frontend_tpu/pwn/converter.py``, the DepthImageConverter analog).

  unproject -> per-pixel interval radii -> integral-image window moments
  -> closed-form 3x3 eigendecomposition -> normals/curvature
  -> point & normal information matrices -> optional sensor-offset transform

with the reference's semantics: radius clamped to [min_image_radius,
max_image_radius]; fewer than min_points valid neighbours give no normal;
normals flipped toward the viewpoint and zeroed above curvature_threshold;
point omegas U diag(flat | 1/eigenvalues) U^T; normal omegas diagonal.
Plain PyTorch on the tensor's device. On a CUDA device each call replays
one CUDA graph captured once per key (``utils/graphs``, the counterpart of
the JAX function's ``jax.jit``) and returns fresh clones of its outputs;
the captured body is `_depth_to_cloud`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import sym6
from ..ops.eigh3x3 import eigh3x3_planar
from ..ops.integral_image import window_moments_planar
from ..utils import graphs
from .cloud import Cloud
from .projector import PinholeProjector


@dataclass(frozen=True)
class ConverterConfig:
    """Defaults follow ``StatsCalculatorIntegralImage`` /
    ``InformationMatrixCalculator`` and the JAX reference's config."""

    world_radius: float = 0.1
    min_image_radius: int = 10
    max_image_radius: int = 30
    min_points: int = 50
    curvature_threshold: float = 0.02
    # static window-radius levels (geometric between min/max radius), as in
    # the reference's default; 0 = exact per-pixel radii
    n_radius_levels: int = 4
    point_flat_info: tuple = (1000.0, 1.0, 1.0)
    normal_flat_info: tuple = (100.0, 100.0, 100.0)
    normal_nonflat_info: tuple = (1.0, 1.0, 1.0)


def radius_levels(cfg: ConverterConfig):
    """The static radius levels of `cfg`, or None for exact radii."""
    if cfg.n_radius_levels <= 0:
        return None
    lo, hi = cfg.min_image_radius, cfg.max_image_radius
    n_lev = min(cfg.n_radius_levels, hi - lo + 1)
    return tuple(
        sorted({int(round(lo * (hi / lo) ** (k / max(n_lev - 1, 1)))) for k in range(n_lev)})
    )


def depth_to_cloud(
    depth,
    projector: PinholeProjector,
    config: ConverterConfig = ConverterConfig(),
    sensor_offset=None,
) -> Cloud:
    """Convert a (H, W) float32 depth tensor to an image-organized Cloud on
    the depth tensor's device. `sensor_offset` (a (4, 4) transform, tensor
    or array) moves the cloud into the sensor's mounting frame."""
    if sensor_offset is not None:
        sensor_offset = torch.as_tensor(sensor_offset, dtype=depth.dtype, device=depth.device)
    return _DEPTH_TO_CLOUD(depth, projector, config, sensor_offset)


def _depth_to_cloud(depth, projector, config, sensor_offset) -> Cloud:
    """`depth_to_cloud`'s body, run eagerly (the CPU) or captured (CUDA)."""
    cfg = config
    points, valid = projector.unproject(depth)
    p = points.movedim(-1, 0).contiguous()  # (3, H, W)

    radii = projector.project_intervals(depth, cfg.world_radius)
    radii = torch.clamp(radii, cfg.min_image_radius, cfg.max_image_radius)
    n, mean, cov6 = window_moments_planar(p, valid, radii, levels=radius_levels(cfg))
    enough = valid & (n >= cfg.min_points)

    lam, V = eigh3x3_planar(cov6)
    lam = tuple(torch.clamp_min(l, 0.0) for l in lam)
    v0 = V[0]  # smallest-eigenvalue direction = surface normal
    # flip toward the viewpoint (camera at origin): n . p < 0
    flip = v0[0] * p[0] + v0[1] * p[1] + v0[2] * p[2] > 0
    sgn = torch.where(flip, -1.0, 1.0)
    normal = tuple(sgn * v0[k] for k in range(3))

    curv = lam[0] / torch.clamp_min(lam[0] + lam[1] + lam[2], 1e-12)
    flat = curv < cfg.curvature_threshold
    has_normal = enough & flat  # the reference zeroes normals on curved areas
    hn = has_normal.to(depth.dtype)
    normal = tuple(hn * nk for nk in normal)

    inv_lam = tuple(1.0 / torch.clamp_min(l, 1e-7) for l in lam)
    diag = tuple(torch.where(flat, cfg.point_flat_info[k], inv_lam[k]) for k in range(3))
    omega_p = hn[None] * sym6.sym_from_diag_frame(V, diag)

    z = torch.zeros_like(curv)
    nf, nn = cfg.normal_flat_info, cfg.normal_nonflat_info
    ones = torch.ones_like(curv)
    on_diag = tuple(torch.where(flat, nf[k] * ones, nn[k] * ones) * hn for k in range(3))
    omega_n = torch.stack([on_diag[0], z, z, on_diag[1], z, on_diag[2]])

    eg = enough.to(depth.dtype)
    cloud = Cloud(
        p=p,
        n=torch.stack(normal),
        curv=torch.where(enough, curv, 1.0),
        ev=torch.stack([eg * l for l in lam]),
        evec=torch.stack([V[k][i] for k in range(3) for i in range(3)]),
        op=omega_p,
        on=omega_n,
        valid=valid,
    )
    if sensor_offset is not None:
        cloud = cloud.transform(torch.as_tensor(sensor_offset, dtype=depth.dtype, device=depth.device))
    return cloud


_DEPTH_TO_CLOUD = graphs.Stage("depth_to_cloud", _depth_to_cloud)
