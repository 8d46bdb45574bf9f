"""Loop closing with partition search and consensus validation (counterpart
of ``g2o_frontend_tpu/slam/map_closer.py``).

Re-design of ``boss_map_building/map_closer.{h,cpp}`` + the PWN instantiation
``pwn_tracker/pwn_closer.{h,cpp}``. Per new keyframe:

1. select map nodes within a pose-distance criterion of the current pose
   (`DistancePoseAcceptanceCriterion`, ``map_utils.h:62``),
2. group them into connected partitions (`makePartitions`,
   ``map_utils.cpp:167``); the partition containing the current node is
   "current", every other partition supplies closure candidates,
3. match all candidates of a partition against the key node at once
   (`pwn_matcher.match_clouds_batch`: one batch-kernel launch per
   Gauss-Newton system on CUDA), gated on image overlap (`matchFrames`
   nonZeros/outliers/inliers gates, ``pwn_closer.cpp:117-143``),
4. consensus: the pairwise translational/rotational consistency matrix of
   all closure relations between two partitions (`validateRelation`,
   ``map_closer.cpp:200-253``) as one vectorized (R, R) check; relations
   checked >= `consensus_min_times_checked` are accepted iff cumInlier >
   cumOutlierTimes, rejected relations are removed
   (``map_closer.cpp:286-430``).

The JAX closer pads each batch to a power-of-two K >= 8 so that XLA
compiles a handful of programs per run; PyTorch runs eagerly, so a batch
here holds exactly the partition's candidates (results on real candidates
are the same). `batch_sizes` records the K of every batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.map_manager import DistancePoseAcceptanceCriterion, MapManager, MapNode, MapRelation
from ..pwn.aligner import AlignerConfig
from ..pwn.projector import PinholeProjector
from .pwn_matcher import match_clouds_batch, stack_clouds


@dataclass
class CloserConfig:
    """Defaults from conf pwn_slam_catacombs_gui.conf PwnCloser line +
    ``map_closer.h:76-78``."""

    translational_distance: float = 3.0
    rotational_distance: float = 0.785398
    consensus_inlier_translational_threshold: float = 0.5
    consensus_inlier_rotational_threshold: float = 0.261799
    consensus_min_times_checked: int = 3
    frame_min_nonzero_threshold: int = 3000
    frame_max_outliers_threshold: int = 100
    frame_min_inliers_threshold: int = 3000
    closure_clamping_distance: float = 0.5


class MapCloser:
    def __init__(
        self,
        manager: MapManager,
        cloud_cache,
        projector: PinholeProjector,
        aligner_config: AlignerConfig = AlignerConfig(),
        config: CloserConfig = CloserConfig(),
        criterion=None,
    ):
        self.manager = manager
        self.cache = cloud_cache
        self.projector = projector
        self.acfg = aligner_config
        self.cfg = config
        # pluggable candidate criterion (``map_closer.cpp:146`` selectNodes
        # with any NodeAcceptanceCriterion; distance by default)
        if criterion is None:
            criterion = DistancePoseAcceptanceCriterion(config.translational_distance, config.rotational_distance)
        self.criterion = criterion
        self.committed: list[MapRelation] = []
        self.batch_sizes: list[int] = []  # K of every candidate batch matched

    # -- candidate generation ----------------------------------------------
    def process_key_node(self, key_node: MapNode) -> list[MapRelation]:
        """Run closure search for a freshly added keyframe node; returns the
        relations committed by this call."""
        self.committed = []
        self.criterion.set_reference_pose(key_node.transform)
        selected = [
            n
            for n in self.manager.select_nodes_by(self.criterion)
            # nodes retired by the map merger stay in the pose array but
            # must not re-enter closure search (slam/map_merger.py);
            # higher-level alias nodes proxy an anchor's pose and carry no
            # sensor payload: closures live within one level
            if n.payload.get("merged_into") is None and n.level == key_node.level
        ]
        if key_node not in selected:
            selected.append(key_node)
        partitions = self.manager.make_partitions(
            selected, relation_selector=lambda r: (not r.is_closure) or r.accepted
        )
        current = next((p for p in partitions if key_node in p), None)
        if current is None or len(partitions) < 2:
            return []
        current_set = set(current)

        for part in partitions:
            if part is current:
                continue
            self._process_partition(part, key_node)
            self._validate_partitions(set(part), current_set)
        return self.committed

    def _process_partition(self, partition: list[MapNode], key_node: MapNode):
        """Match ALL candidate nodes of a partition against the key node in
        one batch (the loop the reference runs serially,
        ``pwn_closer.cpp:92-110``), then add a closure relation for every
        candidate that passes the image-overlap gates."""
        cfg = self.cfg
        cur_cloud = self.cache.get(key_node.payload["frame"])
        iT = np.linalg.inv(key_node.transform)
        cands = [
            o
            for o in partition
            if o is not key_node and "frame" in o.payload and o.payload["frame"] in self.cache
        ]
        if not cands:
            return
        clouds = [self.cache.get(o.payload["frame"]) for o in cands]
        guesses = np.stack([np.linalg.inv(iT @ o.transform) for o in cands]).astype(np.float32)
        res = match_clouds_batch(
            stack_clouds(clouds),
            cur_cloud,
            self.projector,
            torch.as_tensor(guesses, device=cur_cloud.p.device),
            self.acfg,
        )
        self.batch_sizes.append(len(cands))
        # one host read of the batch's results
        nz_all, outl_all, inl_all, T_all, info_all = (
            x.cpu().numpy()
            for x in (res.image_nonzeros, res.image_outliers, res.image_inliers, res.transform, res.information)
        )
        for k, other in enumerate(cands):
            if (
                nz_all[k] < cfg.frame_min_nonzero_threshold
                or outl_all[k] > cfg.frame_max_outliers_threshold
                or inl_all[k] < cfg.frame_min_inliers_threshold
            ):
                continue
            # a degenerate alignment can return a singular covariance ->
            # Inf/NaN omega; such a candidate carries no usable constraint
            if not (np.all(np.isfinite(T_all[k])) and np.all(np.isfinite(info_all[k]))):
                continue
            self.manager.add_relation(
                MapRelation(
                    node_from=other,
                    node_to=key_node,
                    transform=T_all[k].astype(np.float64),
                    information=info_all[k].astype(np.float64),
                    is_closure=True,
                )
            )

    # -- consensus ----------------------------------------------------------
    def _closure_relations_between(self, other_set, current_set):
        rels = []
        for n in other_set:
            for r in self.manager.node_relations(n):
                if not r.is_closure or r.accepted:
                    continue
                a, b = r.node_from, r.node_to
                if (a in other_set and b in current_set) or (b in other_set and a in current_set):
                    if r not in rels:
                        rels.append(r)
        return rels

    def _validate_partitions(self, other_set, current_set):
        cfg = self.cfg
        rels = self._closure_relations_between(other_set, current_set)
        R = len(rels)
        if R == 0:
            return
        # orient every relation current->other: tc (node in current), to
        tc = np.zeros((R, 4, 4))
        to = np.zeros((R, 4, 4))
        tr = np.zeros((R, 4, 4))
        for i, r in enumerate(rels):
            if r.node_from in current_set:
                tc[i] = r.node_from.transform
                to[i] = r.node_to.transform
                tr[i] = np.linalg.inv(r.transform)
            else:
                tc[i] = r.node_to.transform
                to[i] = r.node_from.transform
                tr[i] = r.transform
            r.consensus_times_checked += 1

        # vectorized pairwise consistency (map_closer.cpp:200-253):
        # hypothesis i fixes the current partition via tfix_i = to_i tr_i tc_i^-1
        tfix = np.einsum("nij,njk,nkl->nil", to, tr, np.linalg.inv(tc))
        # relation j evaluated under hypothesis i:
        # trp = to_j^-1 tfix_i tc_j ; te = tr_j^-1 trp
        to_inv = np.linalg.inv(to)
        tr_inv = np.linalg.inv(tr)
        trp = np.einsum("jab,ibc,jcd->ijad", to_inv, tfix, tc)
        te = np.einsum("jab,ijbd->ijad", tr_inv, trp)
        t_err = np.sum(te[..., :3, 3] ** 2, -1)  # squared, as the reference
        cos_a = np.clip((np.trace(te[..., :3, :3], axis1=-2, axis2=-1) - 1) / 2, -1, 1)
        r_err = np.abs(np.arccos(cos_a))

        # NOTE: the reference compares SQUARED translational error against
        # the linear threshold (map_closer.cpp:246,352), kept verbatim.
        is_in = (t_err < cfg.consensus_inlier_translational_threshold) & (
            r_err < cfg.consensus_inlier_rotational_threshold
        )
        for i in range(R):
            inliers_count = int(is_in[i].sum())
            for j in range(R):
                if is_in[i, j]:
                    rels[j].consensus_cum_inlier += inliers_count
                else:
                    rels[j].consensus_cum_outlier_times += 1

        for r in rels:
            if r.consensus_times_checked < cfg.consensus_min_times_checked:
                continue
            if r.consensus_cum_inlier > r.consensus_cum_outlier_times:
                r.accepted = True
                self.committed.append(r)
            else:
                self.manager.remove_relation(r)
