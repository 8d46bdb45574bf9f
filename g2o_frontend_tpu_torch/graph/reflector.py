"""Map <-> solver reflector (counterpart of
``g2o_frontend_tpu/graph/reflector.py``, the MapG2OReflector analog).

The reference mirrors its MapManager into a g2o SparseOptimizer
(``boss_map_building/map_g2o_reflector.h:15-74``). Here the mirror target
is the flat-tensor `PoseGraph3D`: `optimize()` packs one level's nodes and
accepted relations, runs `optimize_se3` on the reflector's device, and
writes the estimates back into the map nodes (float64 on the host).
"""
from __future__ import annotations

import bisect

import numpy as np
import torch

from ..solvers.pose_graph import optimize_se3
from ..utils import lie
from .map_manager import MapManager
from .store import PoseGraph3D, _cap


def _T_to_pose7(T):
    q = lie.mat2quat_full(torch.as_tensor(T[:3, :3], dtype=torch.float32)).numpy()
    return np.concatenate([T[:3, 3], q[1:], q[:1]])


def _adjoint_se3(T):
    """SE3 adjoint (6x6, [t-block; r-block] ordering matching the
    right-multiplied twist chart of solvers.pose_graph.linearize_se3):
    Ad = [[R, skew(t) R], [0, R]]."""
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    sk = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    Ad = np.zeros((6, 6))
    Ad[:3, :3] = R
    Ad[:3, 3:] = sk @ R
    Ad[3:, 3:] = R
    return Ad


def _pose7_to_T(p):
    T = np.eye(4)
    T[:3, :3] = lie.quat2mat(torch.as_tensor(p[3:6], dtype=torch.float32)).numpy()
    T[:3, 3] = p[:3]
    return T


class MapReflector:
    """Pack a MapManager into a PoseGraph3D, optimize, reflect back.

    Solves operate on ONE map level at a time (default 0): alias vertices
    and their chain relations never enter the flat solve (they would
    double-count the path), as the reference's per-level optimizer
    (``map_g2o_reflector.h:50-87``). `optimize_hierarchical` adds the
    coarse-then-fine pass over the MapMerger's level-1 layer. The solver
    runs on `device`.
    """

    def __init__(self, manager: MapManager, device="cuda"):
        self.manager = manager
        self.device = torch.device(device)
        self.last_cg_iters = 0  # CG iterations of the last optimize

    def _pack(self, nodes, rels, gauge_idx) -> PoseGraph3D:
        n, ep = len(nodes), len(rels)
        NP, EP = _cap(max(n, 1)), _cap(max(ep, 1))
        poses = np.zeros((NP, 7))
        poses[:, 6] = 1.0
        for i, nd in enumerate(nodes):
            poses[i] = _T_to_pose7(nd.transform)
        pp_ij = np.zeros((EP, 2), np.int64)
        pp_z = np.zeros((EP, 7))
        pp_z[:, 6] = 1.0
        pp_w = np.zeros((EP, 6, 6))
        for k, (i, j, T, info) in enumerate(rels):
            pp_ij[k] = (i, j)
            pp_z[k] = _T_to_pose7(T)
            pp_w[k] = info
        fixed = np.zeros(NP, bool)
        if n:
            fixed[gauge_idx] = True

        def dev(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        return PoseGraph3D(
            poses=dev(poses, torch.float32),
            pose_mask=dev(np.arange(NP) < n),
            pp_ij=dev(pp_ij),
            pp_meas=dev(pp_z, torch.float32),
            pp_info=dev(pp_w, torch.float32),
            pp_mask=dev(np.arange(EP) < ep),
            fixed=dev(fixed),
        )

    def _level_nodes_rels(self, level):
        nodes = [n for n in self.manager.nodes if n.level == level]
        idx_of = {id(n): i for i, n in enumerate(nodes)}
        rels = [
            (idx_of[id(r.node_from)], idx_of[id(r.node_to)], r.transform, r.information)
            for r in self.manager.relations
            if ((not r.is_closure) or r.accepted) and id(r.node_from) in idx_of and id(r.node_to) in idx_of
        ]
        return nodes, rels, idx_of

    def build_graph(self, gauge_node=None, level=0) -> PoseGraph3D:
        nodes, rels, idx_of = self._level_nodes_rels(level)
        gauge = idx_of.get(id(gauge_node), 0) if gauge_node is not None else 0
        return self._pack(nodes, rels, gauge)

    def optimize(self, iters=10, cg_iters=50, gauge_node=None, level=0, precond="jacobi") -> float:
        nodes, rels, idx_of = self._level_nodes_rels(level)
        if not nodes:
            return 0.0
        gauge = idx_of.get(id(gauge_node), 0) if gauge_node is not None else 0
        g = self._pack(nodes, rels, gauge)
        g_opt, stats = optimize_se3(g, iters=iters, cg_iters=cg_iters, precond=precond)
        poses = g_opt.poses.cpu().numpy()
        for i, nd in enumerate(nodes):
            nd.transform = _pose7_to_T(poses[i].astype(np.float64))
        self.last_cg_iters = stats.cg_iters
        return float(stats.chi2[-1])

    def optimize_hierarchical(self, iters=10, cg_iters=50, gauge_node=None, coarse_iters=12, coarse_cg=60,
                              precond="chain"):
        """Coarse-solve the MapMerger's level-1 big-node layer, rigidly warp
        each keyframe group by its big node's correction, then fine-solve
        level 0 warm-started (the reference's hierarchical intent:
        ``map_core.h`` MapNodeAlias levels feeding per-level optimization).

        Accepted level-0 closures are LIFTED to level 1 on the fly:
        closure (a -> b, T_ab) becomes (A -> B, O_a T_ab O_b^-1) with
        ``O_x = T_anchor(x)^-1 T_x`` the current intra-group offset, its
        information transported by the adjoint of O_b^-1.

        Returns (chi2, {"coarse_cg": int, "fine_cg": int}).
        """
        mgr = self.manager
        aliases = [n for n in mgr.nodes if n.level == 1]
        if len(aliases) < 3:
            chi2 = self.optimize(iters, cg_iters, gauge_node, precond=precond)
            return chi2, {"coarse_cg": 0, "fine_cg": self.last_cg_iters}

        anchors = sorted(aliases, key=lambda a: a.original.seq)
        anchor_seqs = [a.original.seq for a in anchors]

        def group_of(seq):
            return max(0, bisect.bisect_right(anchor_seqs, seq) - 1)

        T_old_inv = [np.linalg.inv(np.array(a.transform)) for a in anchors]
        aidx = {id(a): i for i, a in enumerate(anchors)}

        # coarse relations: the level-1 chain + the lifted closures
        rels = [
            (aidx[id(r.node_from)], aidx[id(r.node_to)], r.transform, r.information)
            for r in mgr.relations
            if id(r.node_from) in aidx and id(r.node_to) in aidx and ((not r.is_closure) or r.accepted)
        ]
        for r in mgr.relations:
            if not (r.is_closure and r.accepted) or r.node_from.level != 0 or r.node_to.level != 0:
                continue
            A, B = group_of(r.node_from.seq), group_of(r.node_to.seq)
            if A == B:
                continue
            O_a = T_old_inv[A] @ r.node_from.transform
            O_b = T_old_inv[B] @ r.node_to.transform
            # the lifted measurement frame is rotated by O_b: transport the
            # information with the adjoint, info' = Ad(O_b^-1)^T info Ad(O_b^-1)
            Ad_inv = _adjoint_se3(np.linalg.inv(O_b))
            info_l = Ad_inv.T @ np.asarray(r.information, np.float64) @ Ad_inv
            rels.append((A, B, O_a @ r.transform @ np.linalg.inv(O_b), info_l))

        gauge = group_of(gauge_node.seq) if gauge_node is not None else 0
        g1 = self._pack(anchors, rels, gauge)
        g1_opt, st1 = optimize_se3(g1, iters=coarse_iters, cg_iters=coarse_cg, precond=precond)
        poses1 = g1_opt.poses.cpu().numpy()
        T_new = [_pose7_to_T(poses1[i].astype(np.float64)) for i in range(len(anchors))]

        # rigid group warp: every level-0 node moves with its big node
        for n in mgr.nodes:
            if n.level == 0:
                gi = group_of(n.seq)
                n.transform = T_new[gi] @ (T_old_inv[gi] @ n.transform)

        chi2 = self.optimize(iters, cg_iters, gauge_node, precond=precond)
        return chi2, {"coarse_cg": st1.cg_iters, "fine_cg": self.last_cg_iters}
