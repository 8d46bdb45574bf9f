"""Submap-based 2D laser SLAM (counterpart of
``g2o_frontend_tpu/slam/grid_slam.py``, mapper/graph_slam's GraphSLAM).

Re-design of ``mapper/graph_slam/graph_slam.{h,cpp}`` (inner/outer `SubMap`
local-map matching over `CorrelativeMatcher`):

- scans accumulate into the current *submap* likelihood grid (anchored at
  the submap's first pose), rebuilt every 5 scans;
- per scan: a coarse-to-fine correlative match against the current submap
  refines odometry and adds a pose-graph edge;
- every `scans_per_submap` scans a new submap starts; finished submaps keep
  their grid;
- *loop closing*: each new submap's first scan is matched against the older
  submaps whose anchors are nearby; a strong peak adds an inter-submap edge;
- `optimize` solves the SE2 pose graph (anchors and scan poses) with the
  port's LM-PCG solver.

The grids and the matches live on `device`; the poses and edges are host
lists, and the small pose algebra runs in float32 on the host with the
port's Lie maps on CPU tensors (a device round trip per scan would cost
more than it computes). A match uploads its scan, thetas and prior in one
buffer and reads its score and pose back in one read.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..graph.store import graph2d_from_log
from ..io.g2o import G2OLog
from ..laser.matcher_refine import gradient_refine
from ..laser.scan_matcher import GridSpec, build_likelihood_map, correlative_match_multires
from ..solvers.pose_graph import optimize_se2
from ..utils import lie


@dataclass
class GridSlamConfig:
    resolution: float = 0.05
    map_half_size: float = 15.0  # meters from submap anchor
    sigma_cells: float = 1.5
    scans_per_submap: int = 20
    search_thetas_deg: float = 10.0
    theta_step_deg: float = 1.0
    search_radius_m: float = 1.5
    min_match_score: float = 8.0
    loop_anchor_distance: float = 8.0
    loop_min_score: float = 12.0
    loop_search_radius_m: float = 4.0
    odom_info: tuple = (400.0, 400.0, 1600.0)
    match_info: tuple = (800.0, 800.0, 3200.0)
    loop_info: tuple = (200.0, 200.0, 800.0)
    max_range: float = 40.0
    gradient_polish_steps: int = 0


def _pad_pow2_pts(pts, min_cap=256):
    """(N, 2) points padded to a power-of-two row count (at least `min_cap`)
    and the count: the JAX version's buckets, so the padded shapes are
    JAX's and the card's FFT plan cache stays small."""
    n = len(pts)
    cap = max(min_cap, 1 << max(0, (n - 1)).bit_length())
    out = np.zeros((cap, 2), np.float32)
    out[:n] = pts
    return out, n


def _se2(fn, *poses):
    """A port Lie map on float32 CPU tensors of host poses -> numpy."""
    return fn(*(torch.as_tensor(np.asarray(p, np.float32)) for p in poses)).numpy()


@dataclass
class SubMap:
    anchor_idx: int  # pose index of the submap anchor
    spec: GridSpec
    points: list = field(default_factory=list)  # scans in the anchor frame (host)
    likelihood: object = None  # (H, W) grid on the device, rebuilt lazily


class GridSlam2D:
    """Host driver: scans and odometry in, trajectory, submaps and a pose
    graph out; grids and matches on `device`."""

    def __init__(self, config: GridSlamConfig = GridSlamConfig(), device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.poses: list[np.ndarray] = []
        self.edges: list = []  # (i, j, z, info)
        self.submaps: list[SubMap] = []
        self._scan_count = 0

    # -- helpers ------------------------------------------------------------
    def _spec(self):
        c = self.cfg
        n = int(2 * c.map_half_size / c.resolution)
        return GridSpec(rows=n, cols=n, resolution=c.resolution, origin_x=-c.map_half_size,
                        origin_y=-c.map_half_size)

    def _rebuild(self, sm: SubMap):
        pts = np.concatenate(sm.points, 0) if sm.points else np.zeros((0, 2), np.float32)
        pad, n = _pad_pow2_pts(pts, min_cap=1024)
        pad = torch.as_tensor(pad, device=self.device)
        valid = torch.arange(len(pad), device=self.device) < n
        sm.likelihood = build_likelihood_map(pad, valid, sm.spec, sigma_cells=self.cfg.sigma_cells)

    # -- main ---------------------------------------------------------------
    def process_scan(self, ranges, angles, odom_delta):
        cfg = self.cfg
        ranges = np.asarray(ranges, np.float32)
        angles = np.asarray(angles, np.float32)
        valid = (ranges > 1e-3) & (ranges < cfg.max_range) & np.isfinite(ranges)
        pts = np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1)[valid]

        if not self.poses:
            self.poses.append(np.zeros(3, np.float32))
            sm = SubMap(anchor_idx=0, spec=self._spec())
            sm.points.append(pts)
            self._rebuild(sm)
            self.submaps.append(sm)
            self._scan_count = 1
            return {"matched": False, "new_submap": True}

        pred = _se2(lie.se2_compose, self.poses[-1], odom_delta)
        self.poses.append(pred.copy())
        i, j = len(self.poses) - 2, len(self.poses) - 1
        self.edges.append((i, j, np.asarray(odom_delta, np.float32), np.diag(cfg.odom_info)))

        sm = self.submaps[-1]
        anchor = self.poses[sm.anchor_idx]
        # scan pose in the submap frame, predicted
        local_pred = _se2(lie.se2_relative, anchor, pred)
        matched = self._match_into(sm, pts, local_pred, j, cfg.search_radius_m, cfg.min_match_score, cfg.match_info)

        # insert the scan into the submap at the current best estimate
        local = _se2(lie.se2_relative, anchor, self.poses[-1])
        c, s = np.cos(local[2]), np.sin(local[2])
        R = np.array([[c, -s], [s, c]], np.float32)
        sm.points.append(pts @ R.T + local[:2])
        self._scan_count += 1

        new_submap = False
        if self._scan_count % cfg.scans_per_submap == 0:
            self._rebuild(sm)  # finalize
            nm = SubMap(anchor_idx=j, spec=self._spec())
            nm.points.append(pts)
            self._rebuild(nm)
            self.submaps.append(nm)
            new_submap = True
            self._close_loops(nm)
        elif len(sm.points) % 5 == 0:
            self._rebuild(sm)

        return {"matched": matched, "new_submap": new_submap}

    def _match_into(self, sm: SubMap, pts, local_pred, pose_idx, radius_m, min_score, info):
        """Correlative-match a scan into a submap; adds an edge on success."""
        cfg = self.cfg
        if sm.likelihood is None:
            self._rebuild(sm)
        thetas = np.deg2rad(np.arange(-cfg.search_thetas_deg, cfg.search_thetas_deg + 1e-6, cfg.theta_step_deg)
                            ).astype(np.float32) + local_pred[2]
        # search around the predicted local pose: one upload of the padded
        # scan, the thetas and the translation prior
        pad, n = _pad_pow2_pts(pts)
        buf = torch.as_tensor(np.concatenate([pad.reshape(-1), thetas, local_pred[:2].astype(np.float32)]),
                              device=self.device)
        cap, k = len(pad), len(thetas)
        res = correlative_match_multires(
            sm.likelihood, buf[: 2 * cap].reshape(cap, 2), torch.arange(cap, device=self.device) < n, sm.spec,
            buf[2 * cap: 2 * cap + k], search_radius_cells=int(radius_m / cfg.resolution),
            translation_prior=buf[2 * cap + k:])
        if cfg.gradient_polish_steps:
            pose_ref, _ = gradient_refine(sm.likelihood, torch.as_tensor(pts, device=self.device),
                                          torch.ones(len(pts), dtype=torch.bool, device=self.device), sm.spec,
                                          res.pose, steps=cfg.gradient_polish_steps)
            res = res._replace(pose=pose_ref)
        out = torch.cat([res.score[None], res.pose]).cpu().numpy()  # the one read of the match
        if out[0] < min_score:
            return False
        match_local = out[1:].astype(np.float32)
        # edge anchor -> pose with measurement = matched local pose
        anchor = self.poses[sm.anchor_idx]
        self.edges.append((sm.anchor_idx, pose_idx, match_local, np.diag(info)))
        # snap the current estimate to the match
        self.poses[pose_idx] = _se2(lie.se2_compose, anchor, match_local)
        return True

    def _close_loops(self, new_sm: SubMap):
        cfg = self.cfg
        a_new = self.poses[new_sm.anchor_idx]
        first_pts = new_sm.points[0]
        for old in self.submaps[:-2]:
            a_old = self.poses[old.anchor_idx]
            if np.linalg.norm(a_new[:2] - a_old[:2]) > cfg.loop_anchor_distance:
                continue
            local_pred = _se2(lie.se2_relative, a_old, a_new)
            self._match_into(old, first_pts, local_pred, new_sm.anchor_idx, cfg.loop_search_radius_m,
                             cfg.loop_min_score, cfg.loop_info)

    # -- optimization -------------------------------------------------------
    def optimize(self, iters=10, cg_iters=100):
        """LM-optimize the pose graph on the device (the first pose fixed);
        the poses take the result. Returns the final chi2."""
        log = G2OLog(
            se2_ids=np.arange(len(self.poses)),
            se2_poses=np.asarray(self.poses, np.float64),
            edge_se2_ij=np.asarray([[i, j] for (i, j, _, _) in self.edges]),
            edge_se2_meas=np.asarray([z for (_, _, z, _) in self.edges]),
            edge_se2_info=np.asarray([w for (_, _, _, w) in self.edges]),
            fixed_ids=np.array([0]),
        )
        g, _ = graph2d_from_log(log, device=self.device)
        g_opt, stats = optimize_se2(g, iters=iters, cg_iters=cg_iters)
        poses = g_opt.poses.cpu().numpy()[: len(self.poses)]
        for k in range(len(self.poses)):
            self.poses[k] = poses[k].astype(np.float32)
        return float(stats.chi2[-1])

    def stats(self):
        return {
            "n_poses": len(self.poses),
            "n_edges": len(self.edges),
            "n_submaps": len(self.submaps),
        }
