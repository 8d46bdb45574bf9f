"""PWN keyframe tracker: RGB-D odometry over the map model (counterpart of
``g2o_frontend_tpu/slam/pwn_tracker.py``).

- Every depth frame is converted to a cloud and aligned against the previous
  keyframe's cloud with initial guess ``prevKF_T^-1 * globalT``
  (``pwn_tracker.cpp:132-135``); on success ``globalT = prevKF_T * T``, below
  `min_cloud_inliers` it falls back to the odometry guess (``:146-152``).
- The rotation is re-orthonormalized every `renormalize_every` frames.
- A frame whose inlier fraction drops below `new_frame_inliers_fraction`
  becomes a keyframe, with a relation from the previous keyframe (``:164-170``).
- Keyframe clouds live in an LRU `CloudCache` that rebuilds evicted clouds
  from the stored depth.

The JAX tracker's band-coverage fallback is gone: the port's association is
exact, so there is no banded window to fall back from.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..graph.map_manager import MapManager, MapNode, MapRelation

from ..pwn.aligner import AlignerConfig, _align, align
from ..pwn.converter import ConverterConfig, _depth_to_cloud, depth_to_cloud
from ..pwn.projector import PinholeProjector
from ..utils import graphs


class CloudCache:
    """LRU keyframe -> cloud cache (``cache.h:17-95`` semantics: bounded
    slots; get() recomputes evicted entries from the stored depth)."""

    def __init__(self, projector, converter_config, max_slots=50):
        self.projector = projector
        self.ccfg = converter_config
        self.max_slots = max_slots
        self._depths: dict[int, torch.Tensor] = {}
        self._clouds: OrderedDict[int, object] = OrderedDict()
        self.evictions = 0
        self.recomputes = 0

    def put(self, key: int, depth):
        self._depths[key] = depth

    def get(self, key: int):
        if key in self._clouds:
            self._clouds.move_to_end(key)
            return self._clouds[key]
        self.recomputes += 1
        cloud = depth_to_cloud(self._depths[key], self.projector, self.ccfg)
        self._clouds[key] = cloud
        if len(self._clouds) > self.max_slots:
            self._clouds.popitem(last=False)
            self.evictions += 1
        return cloud

    def __contains__(self, key):
        return key in self._depths


@dataclass
class PwnTrackerConfig:
    new_frame_inliers_fraction: float = 0.4  # pwn_tracker.h:58 default
    min_cloud_inliers: int = 3000  # conf PwnTracker minCloudInliers
    renormalize_every: int = 50
    cache_slots: int = 50


def _as_depth(depth, device):
    if not torch.is_tensor(depth):
        depth = torch.from_numpy(np.asarray(depth, np.float32))
    return depth.to(device=device, dtype=torch.float32)


class PwnTracker:
    """Host loop: feed depth images, get keyframes + relations in a map.
    Clouds and alignments run on `device`; poses are kept on the host in
    float64, as in the reference."""

    def __init__(
        self,
        projector: PinholeProjector,
        converter_config: ConverterConfig = ConverterConfig(),
        aligner_config: AlignerConfig = AlignerConfig(),
        config: PwnTrackerConfig = PwnTrackerConfig(),
        manager: MapManager | None = None,
        device="cuda",
    ):
        self.projector = projector
        self.ccfg = converter_config
        self.acfg = aligner_config
        self.cfg = config
        self.device = torch.device(device)
        self.manager = manager or MapManager()
        self.cache = CloudCache(projector, converter_config, config.cache_slots)

        self.global_T = np.eye(4)
        self.prev_kf_T = np.eye(4)
        self.prev_kf_node: MapNode | None = None
        self.prev_kf_key: int | None = None
        self.frame_count = 0
        self.n_keyframes = 0
        self.trajectory: list[np.ndarray] = []
        self.metrics: list[dict] = []

    def process_frame(self, depth, initial_guess=None):
        """Ingest one (H, W) depth image in meters; returns the frame metrics."""
        cfg = self.cfg
        depth = _as_depth(depth, self.device)
        current = depth_to_cloud(depth, self.projector, self.ccfg)
        frame_key = self.frame_count
        self.frame_count += 1

        if self.prev_kf_node is None:
            # bootstrap: the first frame is the first keyframe
            self.cache.put(frame_key, depth)
            node = self.manager.add_node(self.global_T, payload={"frame": frame_key})
            self.prev_kf_node = node
            self.prev_kf_key = frame_key
            self.prev_kf_T = self.global_T.copy()
            self.n_keyframes = 1
            self.trajectory.append(self.global_T.copy())
            m = {"keyframe": True, "inliers": 0, "fraction": 1.0, "fallback": False}
            self.metrics.append(m)
            return m

        reference = self.cache.get(self.prev_kf_key)
        guess = np.linalg.inv(self.prev_kf_T) @ self.global_T
        if initial_guess is not None:
            guess = guess @ np.asarray(initial_guess)
        res = align(reference, current, self.projector, guess.astype(np.float32), self.acfg)
        inliers = int(res.inliers)
        T = res.T.cpu().numpy().astype(np.float64)

        fallback = inliers < max(1, cfg.min_cloud_inliers)
        if fallback:
            self.global_T = self.global_T @ guess  # odometry fallback
        else:
            self.global_T = self.prev_kf_T @ T

        if self.frame_count % cfg.renormalize_every == 0:
            U, _, Vt = np.linalg.svd(self.global_T[:3, :3])
            self.global_T[:3, :3] = U @ Vt
        self.trajectory.append(self.global_T.copy())

        fraction = inliers / (self.projector.rows * self.projector.cols)
        new_keyframe = fallback or fraction < cfg.new_frame_inliers_fraction

        if new_keyframe:
            self.cache.put(frame_key, depth)
            node = self.manager.add_node(self.global_T, payload={"frame": frame_key})
            info = res.omega.cpu().numpy().astype(np.float64)
            if fallback or not np.isfinite(info).all():
                info = np.eye(6) * 100.0
            else:
                # bound the information scale (only its anisotropy matters)
                info = 0.5 * (info + info.T)
                mx = np.abs(info).max()
                if mx > 1e4:
                    info *= 1e4 / mx
            self.manager.add_relation(
                MapRelation(
                    node_from=self.prev_kf_node,
                    node_to=node,
                    transform=np.linalg.inv(self.prev_kf_T) @ self.global_T,
                    information=info,
                )
            )
            self.prev_kf_node = node
            self.prev_kf_key = frame_key
            self.prev_kf_T = self.global_T.copy()
            self.n_keyframes += 1

        m = {
            "keyframe": bool(new_keyframe),
            "inliers": inliers,
            "fraction": float(fraction),
            "fallback": bool(fallback),
            "chi2": float(res.chi2),
        }
        self.metrics.append(m)
        return m

    def trajectory_array(self):
        return np.stack(self.trajectory) if self.trajectory else np.zeros((0, 4, 4))


def _depth_batch(depths, device, depth_scale):
    """(K, H, W) depths -> float32 meters on `device`. Raw uint16 counts
    (with `depth_scale`) travel as int16 bits, half the bytes of float32,
    and widen on the device: torch's uint16 supports few operations."""
    if depth_scale is None:
        return _as_depth(depths, device)
    raw = np.ascontiguousarray(depths, np.uint16).view(np.int16)
    counts = torch.from_numpy(raw).to(device).to(torch.int32) & 0xFFFF
    return counts.to(torch.float32) * depth_scale


def odometry_scan(
    depths,
    projector: PinholeProjector,
    ccfg: ConverterConfig = ConverterConfig(),
    acfg: AlignerConfig = AlignerConfig(),
    kf_fraction: float = 0.4,
    min_cloud_inliers: int = 3000,
    depth_scale: float | None = None,
    device="cuda",
):
    """Whole-sequence odometry with no host synchronisation per frame (the
    JAX function's ``lax.scan``).

    The keyframe policy of `PwnTracker` runs as tensor selects on the device:
    the carried reference cloud, keyframe pose and global pose switch with
    ``torch.where``. `depths` is a (K, H, W) float batch in meters, or raw
    uint16 counts with their meters-per-count `depth_scale`. One frame is
    one `_scan_step`; on a CUDA device the step is captured once as a CUDA
    graph and replayed once a frame, its carry kept in the graph's buffers
    (``utils/graphs.Stage.scan``), and the first frame's cloud comes from
    `depth_to_cloud`'s graph.

    Returns (trajectory (K, 4, 4) world poses, metrics dict of (K,) tensors:
    inliers, fraction, keyframe, omega_trace), all fresh tensors, as the
    JAX function's outputs are fresh arrays.
    """
    depths = _depth_batch(depths, torch.device(device), depth_scale)
    eye = torch.eye(4, dtype=torch.float32, device=depths.device)
    ref = depth_to_cloud(depths[0], projector, ccfg)
    _, outs = _SCAN_STEP.scan((ref, eye, eye), depths[1:], projector, ccfg, acfg, kf_fraction, min_cloud_inliers)
    return scan_outputs(eye, outs)


def _scan_step(carry, depth, projector, ccfg, acfg, kf_fraction, min_cloud_inliers):
    """One frame of `odometry_scan` (the body of the JAX function's
    ``lax.scan``): carry (reference cloud, keyframe pose, global pose) and
    one (H, W) depth in; the new carry and the frame's (global pose,
    inliers, inlier fraction, keyframe flag, omega trace) out."""
    ref, kf_T, global_T = carry
    cur = _depth_to_cloud(depth, projector, ccfg, None)
    guess = torch.linalg.solve_ex(kf_T, global_T, check_errors=False).result
    res = _align(ref, cur, projector, guess, acfg, None)
    ok = res.inliers >= max(1, min_cloud_inliers)
    global_T = torch.where(ok, kf_T @ res.T, global_T @ guess)
    frac = res.inliers / (projector.rows * projector.cols)
    new_kf = (frac < kf_fraction) | ~ok
    ref = type(ref)(*(torch.where(new_kf, b, a) for a, b in zip(ref, cur)))
    kf_T = torch.where(new_kf, global_T, kf_T)
    omega_tr = torch.trace(res.omega) + res.translational_ratio + res.rotational_ratio
    return (ref, kf_T, global_T), (global_T, res.inliers, frac, new_kf, omega_tr)


def scan_outputs(first_pose, outs):
    """`odometry_scan`'s outputs from the first frame's pose and the steps'
    outputs: (trajectory (K, 4, 4), metrics dict of (K,) tensors)."""
    dev = first_pose.device
    traj, inliers, fraction, keyframe, omega_tr = ([o[i] for o in outs] for i in range(5))

    def col(xs, first, dtype):
        return torch.stack([torch.full((), first, dtype=dtype, device=dev)] + [x.to(dtype) for x in xs])

    return torch.stack([first_pose] + traj), {
        "inliers": col(inliers, 0, torch.int32),
        "fraction": col(fraction, 1.0, torch.float32),
        "keyframe": col(keyframe, True, torch.bool),
        "omega_trace": col(omega_tr, 0.0, torch.float32),
    }


_SCAN_STEP = graphs.Stage("odometry_scan step", _scan_step)
