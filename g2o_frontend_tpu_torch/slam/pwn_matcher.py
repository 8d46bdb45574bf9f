"""Cloud-pair matching with image-overlap statistics (counterpart of
``g2o_frontend_tpu/slam/pwn_matcher.py``, the PwnMatcherBase analog).

Wraps the aligner and adds the depth-image comparison statistics the
closer gates on (``pwn_matcher_base.cpp:130-182``): render both clouds at
the final transform, count overlapping pixels (nonzeros), pixels whose
depth agrees within 50 mm (image inliers), and their complement (image
outliers). The closure information matrix is the reference's own 100*I
(``pwn_matcher_base.cpp:146-149``).

Everything runs on the clouds' device and returns tensors: the caller
decides when to read them on the host. `match_clouds_batch` matches K
candidate references against one shared current cloud through
`aligner.align_batch` (the batch kernel on CUDA) and renders the K
overlaps in one scatter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..pwn.aligner import AlignerConfig, align, align_batch
from ..pwn.cloud import Cloud
from ..pwn.projector import PinholeProjector

# depth agreement (mm) of an image inlier (``pwn_matcher_base.cpp:130-182``)
FRAME_INLIER_DEPTH_MM = 50.0


class MatcherResult(NamedTuple):
    """One match; `match_clouds_batch` gives every field a leading K axis."""

    transform: torch.Tensor  # (4, 4) to -> from
    information: torch.Tensor  # (6, 6)
    cloud_inliers: torch.Tensor  # aligner inliers
    image_nonzeros: torch.Tensor
    image_inliers: torch.Tensor
    image_outliers: torch.Tensor
    reprojection_distance: torch.Tensor  # mean |depth diff| (mm) over overlap
    valid: torch.Tensor  # aligner validity gates


def _render_depth(projector: PinholeProjector, points, valid):
    """Depth images (..., H, W) of point sets (..., H, W, 3): the depth that
    `PinholeProjector.project` renders, for every leading index at once
    (one scatter-min, each image with its own block of slots)."""
    lead = points.shape[:-3]
    H, W = projector.rows, projector.cols
    pts = points.reshape(-1, H * W, 3)
    ok = valid.reshape(-1, H * W)
    n_img = pts.shape[0]
    u, v, d = projector.pixel_of(pts)
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inside = (
        ok
        & (d > projector.min_distance)
        & (d < projector.max_distance)
        & (ui >= 0)
        & (ui < W)
        & (vi >= 0)
        & (vi < H)
    )
    slot = H * W + 1  # one overflow slot per image
    base = torch.arange(n_img, device=d.device)[:, None] * slot
    flat_pix = base + torch.where(inside, vi * W + ui, H * W)
    big = torch.full((n_img * slot,), float("inf"), dtype=d.dtype, device=d.device)
    dmin = big.scatter_reduce(
        0, flat_pix.reshape(-1), torch.where(inside, d, float("inf")).reshape(-1), reduce="amin"
    ).reshape(n_img, slot)[:, : H * W]
    depth = torch.where(torch.isfinite(dmin), dmin, 0.0)
    return depth.reshape(lead + (H, W))


def _overlap_stats(res, reference: Cloud, current: Cloud, projector) -> MatcherResult:
    """Image-overlap statistics at the matched pose
    (``pwn_matcher_base.cpp:130-182``); `res` and `reference` may carry a
    leading K axis."""
    invT = torch.linalg.inv_ex(res.T, check_errors=False).inverse  # a general inverse, as the JAX matcher
    R, t = invT[..., :3, :3], invT[..., :3, 3]
    ref_pts = reference.points  # (..., H, W, 3)
    ref_in_cur = torch.einsum("...ij,...hwj->...hwi", R, ref_pts) + t[..., None, None, :]
    ref_depth = _render_depth(projector, ref_in_cur, reference.valid)
    cur_depth = _render_depth(projector, current.points, current.valid)

    # 16UC1 conversion in the reference = millimeters
    ref_mm = ref_depth * 1000.0
    cur_mm = cur_depth * 1000.0
    mask = (ref_mm > 0) & (cur_mm > 0)
    diff = torch.abs(cur_mm - ref_mm)
    nonzeros = mask.sum((-2, -1))
    inliers = (mask & (diff < FRAME_INLIER_DEPTH_MM)).sum((-2, -1))
    rep = torch.where(mask, diff, 0.0).sum((-2, -1)) / torch.clamp_min(nonzeros, 1)

    eye = torch.eye(6, dtype=res.T.dtype, device=res.T.device)
    info = (eye * 100.0).expand(res.T.shape[:-2] + (6, 6))  # reference's closure HACK
    return MatcherResult(
        transform=res.T,
        information=info,
        cloud_inliers=res.inliers,
        image_nonzeros=nonzeros,
        image_inliers=inliers,
        image_outliers=nonzeros - inliers,
        reprojection_distance=rep,
        valid=res.valid,
    )


def match_clouds(
    reference: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guess=None,
    config: AlignerConfig = AlignerConfig(),
) -> MatcherResult:
    """Align + image-overlap statistics, on the clouds' device."""
    res = align(reference, current, projector, initial_guess, config)
    return _overlap_stats(res, reference, current, projector)


def match_clouds_batch(
    references: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guesses,
    config: AlignerConfig = AlignerConfig(),
) -> MatcherResult:
    """Match K candidate reference clouds (stacked along a leading axis,
    `stack_clouds`) against one current cloud with (K, 4, 4) initial
    guesses: `align_batch`, then the K overlap statistics at once. Row k
    equals `match_clouds` of that pair.

    The inversion of the reference closer's serial candidate loop
    (``pwn_closer.cpp:92-110`` calls ``matchFrames`` per candidate).
    """
    res = align_batch(references, current, projector, initial_guesses, config)
    return _overlap_stats(res, references, current, projector)


def stack_clouds(clouds) -> Cloud:
    """Stack a list of same-shape `Cloud`s along a new leading axis."""
    return Cloud(*(torch.stack(fields) for fields in zip(*clouds)))


def make_thumbnails(cloud: Cloud, projector: PinholeProjector, scale: int = 4):
    """Depth + normal thumbnails of a cloud (``pwn_matcher_base.h:48-53``).

    The reference renders a scaled-down depth image and an RGB normal image
    (channels = 127*(1 - n)) used by closers and viewers for cheap overlap
    screening and debugging. Returns (depth (h, w) float32 meters,
    normals (h, w, 3) uint8).
    """
    sp = projector.scaled(scale)
    depth, idx = sp.project(cloud.points, cloud.valid)
    flat_n = cloud.normals.reshape(-1, 3)
    n_img = torch.where((idx >= 0)[..., None], flat_n[torch.clamp_min(idx, 0).to(torch.int64)], 0.0)
    n_rgb = (127.0 * (1.0 - n_img)).to(torch.uint8)
    return depth, n_rgb
