"""Multi-graph matching and merging (counterpart of
``g2o_frontend_tpu/slam/graph_merge.py``; the graph_merge toolkit of the
reference, ``graph_matcher.h:19-66``, ``graph_merge.cpp:38``,
``match_merge.cpp:47``):

- `match_graphs`: the SE2 transform between two pose graphs from tentative
  node correspondences: gated NN over node positions under an initial
  guess, then vectorized RANSAC with the Horn2D solver on the device, its
  hypotheses drawn by a CPU generator seeded from `seed`;
- `merge_graphs`: graph B mapped into A's frame, concatenated, and joined
  by inter-graph edges at the matched node pairs;
- `overlap_score`: the metric of ``compute_score.cpp``, the share of B's
  nodes within a radius of some node of A after alignment;
- `map_entropy`: the summed cell entropy of an occupancy grid
  (``compute_entropy.cpp:10-78``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.g2o import G2OLog
from ..ransac import solvers as rsolvers
from ..ransac.engine import ransac
from ..utils import lie


@dataclass
class GraphMatchResult:
    transform: np.ndarray  # (3,) SE2 chart: B -> A
    pairs: list  # [(idx_a, idx_b)]
    ok: bool


def match_graphs(
    poses_a,
    poses_b,
    initial_guess=np.zeros(3),
    gate: float = 2.0,
    inlier_threshold: float = 0.5,
    n_hypotheses: int = 512,
    seed: int = 0,
    device="cuda",
) -> GraphMatchResult:
    """Find T mapping graph-B poses into graph-A's frame."""
    A = torch.as_tensor(np.asarray(poses_a, np.float32), device=device)
    B = torch.as_tensor(np.asarray(poses_b, np.float32), device=device)
    Bg = lie.se2_apply(torch.as_tensor(np.asarray(initial_guess, np.float32), device=device), B[:, :2])
    # gated NN from B to A
    d2 = ((Bg[:, None, :] - A[None, :, :2]) ** 2).sum(-1)
    best = d2.min(1)
    ok = best.values < gate * gate
    nn = best.indices
    if int(ok.sum()) < 3:
        return GraphMatchResult(np.asarray(initial_guess), [], False)
    res = ransac(
        torch.Generator().manual_seed(seed),
        A[nn, :2],
        B[:, :2],
        ok,
        fit_fn=rsolvers.fit_se2_points,
        err_fn=rsolvers.err_se2_points,
        minimal_size=2,
        inlier_threshold=inlier_threshold**2,
        n_hypotheses=n_hypotheses,
        min_inliers=3,
    )
    keep = (ok & res.inliers).cpu().numpy()
    nn = nn.cpu().numpy()
    pairs = [(int(nn[i]), i) for i in range(len(keep)) if keep[i]]
    return GraphMatchResult(res.transform.cpu().numpy(), pairs, bool(res.ok))


def overlap_score(poses_a, poses_b, transform, radius: float = 1.0, device="cuda") -> float:
    """Fraction of B nodes landing within `radius` of an A node."""
    A = torch.as_tensor(np.asarray(poses_a, np.float32)[:, :2], device=device)
    B = lie.se2_apply(torch.as_tensor(np.asarray(transform, np.float32), device=device),
                      torch.as_tensor(np.asarray(poses_b, np.float32)[:, :2], device=device))
    d2 = ((B[:, None] - A[None]) ** 2).sum(-1).min(1).values
    return int((d2 < radius * radius).sum()) / d2.shape[0]


def map_entropy(occupancy, hit_counts=None, device="cuda"):
    """Total entropy of an occupancy grid (``compute_entropy.cpp:10-78``).

    ``occupancy`` holds each cell's occupancy probability in [0, 1], with
    unknown cells < 0 (or NaN). Returns (total_entropy, per_cell_map): the
    map holds -p log p - (1-p) log(1-p), and -1 for unknown cells; lower
    total = crisper merged map (the reference's merge-quality metric).
    """
    p = torch.as_tensor(np.asarray(occupancy, np.float32), device=device)
    known = (p >= 0.0) & (p <= 1.0) & torch.isfinite(p)
    pc = torch.clamp(p, 1e-6, 1.0 - 1e-6)
    h = -(pc * torch.log(pc) + (1.0 - pc) * torch.log(1.0 - pc))
    h = torch.where(known, h, -1.0)
    total = torch.where(known, h, 0.0).sum()
    return total, h


def merge_graphs(log_a: G2OLog, log_b: G2OLog, match: GraphMatchResult, link_info=None, device="cuda") -> G2OLog:
    """Concatenate graph B (remapped by match.transform) onto graph A with
    inter-graph edges at the matched node pairs, each measuring the pair's
    current relative pose."""
    T = torch.as_tensor(np.asarray(match.transform, np.float32), device=device)
    id_off = (int(log_a.se2_ids.max()) + 1) if len(log_a.se2_ids) else 0
    poses_b = lie.se2_compose(T, torch.as_tensor(np.asarray(log_b.se2_poses, np.float32), device=device))
    if link_info is None:
        link_info = np.diag([100.0, 100.0, 400.0])
    ia = np.asarray([a for a, _ in match.pairs], np.int64)
    ib = np.asarray([b for _, b in match.pairs], np.int64)
    za = torch.as_tensor(np.asarray(log_a.se2_poses, np.float32)[ia].reshape(-1, 3), device=device)
    link_z = lie.se2_relative(za, poses_b[torch.as_tensor(ib, device=device)]).cpu().numpy()
    link_ij = np.stack([log_a.se2_ids[ia], log_b.se2_ids[ib] + id_off], 1).astype(np.int64).reshape(-1, 2)
    link_w = np.broadcast_to(np.asarray(link_info), (len(ia), 3, 3))

    return G2OLog(
        se2_ids=np.concatenate([log_a.se2_ids, log_b.se2_ids + id_off]),
        se2_poses=np.concatenate([log_a.se2_poses, poses_b.cpu().numpy()]),
        edge_se2_ij=np.concatenate([log_a.edge_se2_ij, log_b.edge_se2_ij + id_off, link_ij]),
        edge_se2_meas=np.concatenate([log_a.edge_se2_meas, log_b.edge_se2_meas, link_z]),
        edge_se2_info=np.concatenate([log_a.edge_se2_info, log_b.edge_se2_info, link_w]),
        fixed_ids=log_a.fixed_ids if len(log_a.fixed_ids) else np.array([0]),
    )
