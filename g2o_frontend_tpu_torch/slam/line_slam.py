"""2D laser line SLAM: extraction + association + line-landmark graph
(counterpart of ``g2o_frontend_tpu/slam/line_slam.py``).

The line_alignment pipeline (BASELINE config 2): per scan, extract line
segments on the device (`laser.line_extraction`), read them back once,
associate them on the host to world line landmarks (gated nearest
neighbour in (alpha, rho) space after the odometry prediction), keep the
landmark set with merging (``line_alignment.cpp:44-650`` correspondence +
updateVertexPointID merge), and optimize the SE2 pose + line graph on the
device (`solvers.line_slam`). The odometry composition runs in float32 on
the host with the port's Lie maps on CPU tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..laser.line_extraction import LineExtractorConfig, LineSet, extract_lines
from ..solvers.line_slam import _line_graph, optimize_line_graph
from ..utils import lie


def lineset_to_params(ls: LineSet):
    """LineSet -> (K, 2) [alpha, rho] + lengths + mask (host numpy), in one
    read of the device."""
    host = torch.cat([ls.normal, ls.rho[:, None], ls.p0, ls.p1, ls.mask[:, None].to(ls.rho.dtype)], 1).cpu().numpy()
    nrm, rho, p0, p1, mask = host[:, :2], host[:, 2], host[:, 3:5], host[:, 5:7], host[:, 7] > 0
    alpha = np.arctan2(nrm[:, 1], nrm[:, 0])
    return np.stack([alpha, rho], -1), np.linalg.norm(p1 - p0, axis=1), mask


def transform_line(pose, line):
    """Local line observed from pose -> world line [alpha, rho]."""
    a_w = line[0] + pose[2]
    n = np.array([np.cos(a_w), np.sin(a_w)])
    r_w = line[1] + n @ pose[:2]
    # canonical: rho >= 0
    if r_w < 0:
        r_w = -r_w
        a_w = a_w + np.pi
    a_w = (a_w + np.pi) % (2 * np.pi) - np.pi
    return np.array([a_w, r_w])


def _line_dist(a, b, rho_weight=1.0):
    """Distance between canonical (rho >= 0) line parameters.

    With the canonical form, (alpha, rho) and (alpha+pi, rho) are DIFFERENT
    lines (opposite sides of the origin): no 180-deg folding."""
    da = np.abs((a[..., 0] - b[..., 0] + np.pi) % (2 * np.pi) - np.pi)
    return da + rho_weight * np.abs(a[..., 1] - b[..., 1])


@dataclass
class LineSlam2DConfig:
    extractor: LineExtractorConfig = LineExtractorConfig()
    assoc_gate: float = 0.35  # combined angle+rho distance gate
    merge_gate: float = 0.15
    min_length: float = 0.5
    odom_info: tuple = (100.0, 100.0, 400.0)
    obs_info: tuple = (400.0, 100.0)  # alpha, rho weights
    optimize_each_n: int = 15
    optimize_iters: int = 6
    cg_iters: int = 50


class LineSlam2D:
    """Host driver: scans + odometry in, line map + trajectory out;
    extraction and solves on `device`."""

    def __init__(self, config: LineSlam2DConfig = LineSlam2DConfig(), device="cuda"):
        self.cfg = config
        self.device = torch.device(device)
        self.poses: list[np.ndarray] = []
        self.lines = np.zeros((0, 2))  # world [alpha, rho]
        self.line_seen = np.zeros(0, np.int64)
        self.pp_edges: list = []
        self.pl_edges: list = []
        self.frame = 0

    def _extract(self, ranges, angles) -> LineSet:
        """The scan's line set, extracted on the device (one upload)."""
        scan = torch.as_tensor(np.stack([np.asarray(ranges, np.float32), np.asarray(angles, np.float32)]),
                               device=self.device)
        return extract_lines(scan[0], scan[1], self.cfg.extractor)

    def process_scan(self, ranges, angles, odom_delta):
        cfg = self.cfg
        if not self.poses:
            self.poses.append(np.zeros(3))
        else:
            pose = lie.se2_compose(torch.as_tensor(np.asarray(self.poses[-1], np.float32)),
                                   torch.as_tensor(np.asarray(odom_delta, np.float32))).numpy()
            self.poses.append(np.asarray(pose, float))
            self.pp_edges.append((len(self.poses) - 2, len(self.poses) - 1, np.asarray(odom_delta, float),
                                  np.diag(cfg.odom_info)))
        pidx = len(self.poses) - 1
        pose = self.poses[-1]

        params, lengths, mask = lineset_to_params(self._extract(ranges, angles))
        obs_info = np.diag(cfg.obs_info)
        n_new = 0
        for k in range(len(params)):
            if not mask[k] or lengths[k] < cfg.min_length:
                continue
            local = params[k]
            world = transform_line(pose, local)
            # associate to existing landmarks
            if len(self.lines):
                d = _line_dist(self.lines, world[None])
                j = int(np.argmin(d))
                if d[j] < cfg.assoc_gate:
                    self.pl_edges.append((pidx, j, local.copy(), obs_info))
                    self.line_seen[j] += 1
                    continue
            # new landmark
            self.lines = np.vstack([self.lines, world[None]])
            self.line_seen = np.append(self.line_seen, 1)
            self.pl_edges.append((pidx, len(self.lines) - 1, local.copy(), obs_info))
            n_new += 1

        self.frame += 1
        if cfg.optimize_each_n and self.frame % cfg.optimize_each_n == 0:
            self.optimize()
        return n_new

    def optimize(self):
        """LM over the whole graph on the device; poses and lines take the
        result. Returns the final chi2.

        The graph is packed at its exact counts, where the JAX package pads
        it (`solvers.line_slam.make_line_graph`): padding changes the
        float32 sums' rounding, which this algorithm amplifies: padded, the
        452-scan world of `chip_smoke.py` made 212 lines on an H100, outside
        its `LINE_BAND` around the JAX package's 189. Stepped beside the
        JAX package, both padded, on the CPU
        (``tools/jax_line_slam_reference.py --lockstep``; ROADMAP.md
        section 3, "Not faults"), the two part only by amplified rounding:
        given the same lines, every solve agrees on the same inputs within
        5.4e-4 m, yet the fourth turns a 2.4e-6 m gap going in into 0.33 m.
        So each solve is a new key of `utils.graphs.solve_loop`: its CG
        blocks replay a graph, its head and tail run eagerly."""
        cfg = self.cfg
        n, nl, ep, el = len(self.poses), len(self.lines), len(self.pp_edges), len(self.pl_edges)
        g = _line_graph(np.asarray(self.poses), self.lines, self.pp_edges, self.pl_edges, (0,), (n, nl, ep, el),
                        torch.float32, self.device)
        g_opt, trace = optimize_line_graph(g, iters=cfg.optimize_iters, cg_iters=cfg.cg_iters)
        poses = g_opt.poses[:n].cpu().double().numpy()
        for i in range(n):
            self.poses[i] = poses[i]
        self.lines = g_opt.lines[:nl].cpu().double().numpy()
        return float(trace[-1])

    def merge_landmarks(self):
        """Merge duplicate line landmarks (updateVertexPointID analog)."""
        cfg = self.cfg
        keep = np.ones(len(self.lines), bool)
        remap = np.arange(len(self.lines))
        for a in range(len(self.lines)):
            if not keep[a]:
                continue
            for b in range(a + 1, len(self.lines)):
                if not keep[b]:
                    continue
                if _line_dist(self.lines[a], self.lines[b]) < cfg.merge_gate:
                    keep[b] = False
                    remap[b] = a
        new_idx = np.cumsum(keep) - 1
        self.pl_edges = [(p, int(new_idx[remap[l]]), z, w) for (p, l, z, w) in self.pl_edges]
        merged = int((~keep).sum())
        self.lines = self.lines[keep]
        self.line_seen = self.line_seen[keep]
        return merged

    def stats(self):
        return {
            "n_poses": len(self.poses),
            "n_lines": len(self.lines),
            "n_obs": len(self.pl_edges),
        }
