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

Each batch is padded, as the JAX closer pads it, to the next power of two
K >= 8 (`padded_k`) with copies of the last candidate's cloud and identity
guesses, so that `align_batch` captures one graph a bucket (8, 16, 32, ...)
and not one for every partition size. A candidate's results do not depend
on the others in its batch; only the real candidates' are read back, and a
padded slot never becomes a relation. `batch_sizes` records the real K of
every batch.

`record`, where it is a list, receives a `BatchRecord` for every batch and
a `ConsensusRecord` for every consensus, built from what the closer reads
on the host anyway.

Spans (``utils/profiling.span``, recorded while a profiler session
records): ``closer:clouds`` around the cache's gets of a batch's clouds
(the recomputes among them) and their stacking, ``closer:match`` (its
request id the padded K) around `match_clouds_batch` and the one host
read of its results, ``closer:consensus`` around a consensus. Counters,
always on: `batches`, `candidates` (real), `padded` (slots added),
`committed` and `rejected` (relations the consensus accepted and removed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..graph.map_manager import DistancePoseAcceptanceCriterion, MapManager, MapNode, MapRelation
from ..pwn.aligner import AlignerConfig
from ..pwn.projector import PinholeProjector
from ..utils.profiling import span
from .pwn_matcher import match_clouds_batch, stack_clouds

# the closer's counters since the process started (or a caller's reset)
batches = 0
candidates = 0
padded = 0
committed = 0
rejected = 0


def padded_k(k: int) -> int:
    """The batch size a batch of `k` candidates is padded to: the next power
    of two of at least 8 (the JAX closer's buckets)."""
    kc = 8
    while kc < k:
        kc *= 2
    return kc


class BatchRecord(NamedTuple):
    """One candidate batch as the closer ran it: the key node's frame, the
    real candidates' frames and (K, 4, 4) guesses, the padded K, and the
    real candidates' results as read back: (K, 4, 4) transforms, (K, 6, 6)
    information, aligner inliers, image nonzeros, inliers and outliers, and
    whether each passed the gates and became a relation."""

    key_frame: int
    frames: list
    guesses: np.ndarray
    padded_k: int
    transform: np.ndarray
    information: np.ndarray
    cloud_inliers: np.ndarray
    image_nonzeros: np.ndarray
    image_inliers: np.ndarray
    image_outliers: np.ndarray
    passed: np.ndarray


class ConsensusRecord(NamedTuple):
    """One consensus between two partitions: for each of its R relations,
    the (R, 4, 4) poses of its endpoints and its transform (from, to,
    relation), whether its `from` node lies in the current partition, its
    counters before (times checked, cumulative inliers, outlier times), and
    its decision: "accepted", "removed" or "pending"."""

    pose_from: np.ndarray
    pose_to: np.ndarray
    transform: np.ndarray
    from_in_current: np.ndarray
    counters_before: np.ndarray
    decisions: list


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
        self.batch_sizes: list[int] = []  # the real K of every candidate batch matched
        self.record: list | None = None  # a list receives every batch's and consensus' record

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
        global batches, candidates, padded
        cfg = self.cfg
        with span("closer:clouds"):
            cur_cloud = self.cache.get(key_node.payload["frame"])
            cands = [
                o
                for o in partition
                if o is not key_node and "frame" in o.payload and o.payload["frame"] in self.cache
            ]
            if not cands:
                return
            clouds = [self.cache.get(o.payload["frame"]) for o in cands]
        iT = np.linalg.inv(key_node.transform)
        guesses = np.stack([np.linalg.inv(iT @ o.transform) for o in cands]).astype(np.float32)
        K, KC = len(cands), padded_k(len(cands))
        nz_all, outl_all, inl_all, cinl_all, T_all, info_all = self.match_batch(cur_cloud, clouds, guesses)
        self.batch_sizes.append(K)
        batches += 1
        candidates += K
        padded += KC - K
        passed = np.zeros(K, bool)
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
            passed[k] = True
            self.manager.add_relation(
                MapRelation(
                    node_from=other,
                    node_to=key_node,
                    transform=T_all[k].copy(),
                    information=info_all[k].copy(),
                    is_closure=True,
                )
            )
        if self.record is not None:
            self.record.append(BatchRecord(
                key_node.payload["frame"], [o.payload["frame"] for o in cands], guesses, KC, T_all, info_all,
                cinl_all, nz_all, inl_all, outl_all, passed))

    def match_batch(self, cur_cloud, clouds, guesses):
        """Match the K candidate `clouds` against `cur_cloud` from the (K, 4, 4)
        float32 `guesses`, the batch padded to `padded_k(K)`: the real
        candidates' image nonzeros, outliers and inliers, aligner inliers,
        (K, 4, 4) transforms and (K, 6, 6) information, read back in one
        copy, on the host."""
        K = len(clouds)
        KC = padded_k(K)
        with span("closer:clouds"):
            refs = stack_clouds(clouds + [clouds[-1]] * (KC - K))
        pad = np.broadcast_to(np.eye(4, dtype=np.float32), (KC - K, 4, 4))
        with span("closer:match", KC):
            res = match_clouds_batch(
                refs,
                cur_cloud,
                self.projector,
                torch.as_tensor(np.concatenate([guesses, pad]), device=cur_cloud.p.device),
                self.acfg,
            )
            # one host read of the real candidates' results, every field
            # exact in float64 (counts below 2^53, float32 values)
            fields = (res.image_nonzeros, res.image_outliers, res.image_inliers, res.cloud_inliers, res.transform,
                      res.information)
            read = torch.cat([x[:K].reshape(K, -1).to(torch.float64) for x in fields], 1).cpu().numpy()
        counts = (read[:, i].astype(np.int64) for i in range(4))
        return (*counts, read[:, 4:20].reshape(K, 4, 4), read[:, 20:].reshape(K, 6, 6))

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
        with span("closer:consensus"):
            self._consensus(other_set, current_set)

    def _consensus(self, other_set, current_set):
        global committed, rejected
        cfg = self.cfg
        rels = self._closure_relations_between(other_set, current_set)
        R = len(rels)
        if R == 0:
            return
        # orient every relation current->other: tc (node in current), to
        tc = np.zeros((R, 4, 4))
        to = np.zeros((R, 4, 4))
        tr = np.zeros((R, 4, 4))
        if self.record is not None:
            before = np.array([(r.consensus_times_checked, r.consensus_cum_inlier, r.consensus_cum_outlier_times)
                               for r in rels])
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

        decisions = []
        for r in rels:
            if r.consensus_times_checked < cfg.consensus_min_times_checked:
                decisions.append("pending")
            elif r.consensus_cum_inlier > r.consensus_cum_outlier_times:
                r.accepted = True
                self.committed.append(r)
                committed += 1
                decisions.append("accepted")
            else:
                self.manager.remove_relation(r)
                rejected += 1
                decisions.append("removed")
        if self.record is not None:
            self.record.append(ConsensusRecord(
                np.stack([r.node_from.transform for r in rels]), np.stack([r.node_to.transform for r in rels]),
                np.stack([r.transform for r in rels]), np.array([r.node_from in current_set for r in rels]),
                before, decisions))
