"""PWN SLAM, one frame at a time: the library entry point of the
``pwn_tracker2/pwn_slam_app.cpp:31`` flow (the loop that
``apps/pwn_slam.run`` drives).

`PwnSlam.process_frame(depth)` does, in this order:

1. `PwnTracker.process_frame` (depth -> cloud -> alignment to the last
   keyframe; a keyframe becomes a map node and a relation);
2. on a keyframe after the second, `MapCloser.process_key_node` (closure
   candidates matched in one `align_batch` a partition, then consensus)
   and `MapMerger.process_key_node` (every `list_size` key nodes one
   level-1 node, the coarse layer of the map solve);
3. `MapReflector.optimize_hierarchical` when the closer committed a
   closure or `optimize_each_n_keyframes` keyframes have passed since the
   last solve;
4. after a solve, the tracker's frame re-anchored on its last keyframe's
   optimized pose.

`warm_up` captures ahead of time the graphs a run would otherwise capture
the first time it reaches a size: `align_batch` at each batch bucket of
the closer (`map_closer.padded_k`) and the map solves at each capacity
(`graph.store._cap`) of the level-0 and level-1 graphs up to a bound.
`finish()` runs the final solve.

A `SlamRecord` put in `record` (None by default, when nothing is
recorded) keeps, on the host, what the run did, from values the tracker,
closer and reflector hold there anyway: each frame's anchor (the keyframe
and poses the tracker aligned from), each closer batch and consensus
(`map_closer.BatchRecord`, `ConsensusRecord`), and each level-0 solve's
graph going in and poses coming out (`reflector.MapSolveRecord`).

Spans (``utils/profiling.span``, recorded while a profiler session
records): ``pwn_slam.frame`` around each `process_frame` (its request id
the frame's number; the tracker's, the closer's and the solve's spans
nest in it), ``closer`` around each closer call (its request id the
keyframe's number), ``map_solve`` around each solve (its request id the
map's node count). Counters: `map_closer.batches`, ``.candidates``,
``.padded``, ``.committed``, ``.rejected``, `reflector.solves`, the cache's
`CloudCache.recomputes`, and this object's `closer_calls` /
`closer_recomputes` (closer calls that ran a batch, and the cache's
recomputes inside them).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..graph.reflector import COARSE_CG_ITERS, COARSE_ITERS, MapReflector
from ..graph.store import _cap
from ..pwn.aligner import AlignerConfig
from ..pwn.converter import ConverterConfig
from ..pwn.projector import PinholeProjector
from ..solvers.pose_graph import optimize_se3
from ..utils.profiling import span
from .map_closer import CloserConfig, MapCloser
from . import pwn_tracker
from .map_merger import MapMerger
from .pwn_tracker import PwnTracker, PwnTrackerConfig


# each map solve's fine (level-0) pass, and the final solve's: LM
# iterations, CG steps
ITERS, CG_ITERS = 5, 40
FINAL_ITERS, FINAL_CG_ITERS = 10, 60
# key nodes a level-1 node (the merger's grouping, ``map_merger.cpp:43``)
LIST_SIZE = 5


class FrameRecord(NamedTuple):
    """What the tracker aligned one frame from: the frame's number, the
    frame of its keyframe (None for the first frame), the keyframe's pose
    and the global pose before the frame, (4, 4) float64."""

    frame: int
    anchor_frame: int | None
    anchor_T: np.ndarray
    pose_before: np.ndarray


@dataclass
class SlamRecord:
    """What a `PwnSlam` run did (the module's docstring)."""

    frames: list = field(default_factory=list)
    closer: list = field(default_factory=list)  # BatchRecord and ConsensusRecord, in order
    solves: list = field(default_factory=list)  # MapSolveRecord


class _Node:
    """A stand-in map node for the warm-up's graphs: a pose alone."""

    def __init__(self, transform):
        self.transform = transform


def _caps(lo, hi):
    """The capacities (`graph.store._cap`) of the sizes from `lo` to `hi`."""
    c, out = _cap(max(lo, 1)), []
    while True:
        out.append(c)
        if c >= hi:
            return out
        c *= 2


class PwnSlam:
    """Tracker, closer, merger and map solve over one map, fed one depth
    frame at a time. Clouds, alignments and solves run on `device`; poses
    stay on the host in float64."""

    def __init__(
        self,
        projector: PinholeProjector,
        converter_config: ConverterConfig = ConverterConfig(),
        aligner_config: AlignerConfig = AlignerConfig(),
        tracker_config: PwnTrackerConfig = PwnTrackerConfig(),
        closer_config: CloserConfig = CloserConfig(),
        optimize_each_n_keyframes: int = 5,
        device="cuda",
    ):
        self.optimize_each_n_keyframes = optimize_each_n_keyframes
        self.tracker = PwnTracker(projector, converter_config, aligner_config, tracker_config, device=device)
        self.manager = self.tracker.manager
        self.closer = MapCloser(self.manager, self.tracker.cache, projector, aligner_config, closer_config)
        self.merger = MapMerger(self.manager, list_size=LIST_SIZE)
        self.reflector = MapReflector(self.manager, device=device)
        self._record = None
        self.n_closures = 0
        self.kf_at_last_opt = 0
        self.closer_calls = 0
        self.closer_recomputes = 0

    @property
    def record(self) -> SlamRecord | None:
        return self._record

    @record.setter
    def record(self, rec: SlamRecord | None):
        self._record = rec
        self.closer.record = None if rec is None else rec.closer
        self.reflector.record = None if rec is None else rec.solves

    def process_frame(self, depth) -> dict:
        """Ingest one (H, W) depth image in meters; returns the tracker's
        frame metrics with ``closures`` (committed by this frame),
        ``batches`` (candidate batches matched) and ``map_solved``."""
        tracker = self.tracker
        with span("pwn_slam.frame", tracker.frame_count):
            if self._record is not None:
                self._record.frames.append(FrameRecord(tracker.frame_count, tracker.prev_kf_key,
                                                       tracker.prev_kf_T.copy(), tracker.global_T.copy()))
            m = dict(tracker.process_frame(depth), closures=0, batches=0, map_solved=False)
            if m["keyframe"] and tracker.n_keyframes > 2:
                key_node = self.manager.nodes[-1]
                batches, recomputes = len(self.closer.batch_sizes), tracker.cache.recomputes
                with span("closer", tracker.n_keyframes - 1):
                    rels = self.closer.process_key_node(key_node)
                m["batches"] = len(self.closer.batch_sizes) - batches
                if m["batches"]:
                    self.closer_calls += 1
                    self.closer_recomputes += tracker.cache.recomputes - recomputes
                self.merger.process_key_node(key_node)
                m["closures"] = len(rels)
                self.n_closures += len(rels)
                if rels or tracker.n_keyframes - self.kf_at_last_opt >= self.optimize_each_n_keyframes:
                    self.solve(ITERS, CG_ITERS)
                    self.kf_at_last_opt = tracker.n_keyframes
                    # keep the tracker's frame anchored to the optimized map
                    tracker.global_T = tracker.prev_kf_node.transform.copy()
                    tracker.prev_kf_T = tracker.global_T.copy()
                    m["map_solved"] = True
            return m

    def solve(self, iters, cg_iters):
        """One hierarchical map solve (coarse level-1 pass, rigid warp, fine
        level-0 pass); returns (chi2, its CG counts)."""
        with span("map_solve", len(self.manager.nodes)):
            return self.reflector.optimize_hierarchical(iters=iters, cg_iters=cg_iters)

    def warm_up(self, buckets=(8, 16, 32, 64, 128), new_keyframes=0, new_closures=0):
        """Capture `align_batch` at each batch size in `buckets`, and the
        map solve (the fine pass and the coarse one) at every capacity from
        the map's present size to that after `new_keyframes` more keyframes
        and `new_closures` more accepted closures, each solve twice (a
        solve's graphs are kept from its second call). Runs on copies of the
        last keyframe's cloud and on chain graphs of each capacity; the map,
        the cache and the counters of the closer and the reflector are left
        as they were."""
        tracker = self.tracker
        if tracker.prev_kf_key is not None:
            cloud = pwn_tracker.depth_to_cloud(tracker.cache._depths[tracker.prev_kf_key], tracker.projector,
                                               tracker.ccfg)
            for kc in buckets:
                k = 1 if kc <= 8 else kc // 2 + 1  # a batch of k candidates is padded to kc
                self.closer.match_batch(cloud, [cloud] * k, np.repeat(np.eye(4, dtype=np.float32)[None], k, 0))
        group = LIST_SIZE + 1
        nodes, rels, _ = self.reflector._level_nodes_rels(0)
        n0, e0 = len(nodes), len(rels)
        n1 = sum(n.level == 1 for n in self.manager.nodes)
        closures = sum(r.is_closure and r.accepted for r in self.manager.relations)
        fine, coarse = (ITERS, CG_ITERS), (COARSE_ITERS, COARSE_CG_ITERS)
        for (iters, cg), (n_lo, n_hi), (e_lo, e_hi) in (
            (fine, (n0, n0 + new_keyframes), (e0, e0 + new_keyframes + new_closures)),
            (coarse, (max(n1, 3), n1 + new_keyframes // group + 1),
             (max(n1 - 1, 1), n1 + new_keyframes // group + closures + new_closures)),
        ):
            for NP in _caps(n_lo, n_hi):
                # a connected graph has at least n - 1 > NP / 2 - 1 relations
                for EP in (e for e in _caps(e_lo, e_hi) if e >= NP // 2):
                    for _ in range(2):
                        self._warm_solve(NP, EP, iters, cg)

    def _warm_solve(self, n, e, iters, cg_iters):
        """A map solve over a chain of `n` nodes and `e` relations (the chain's
        relations repeated), `n` and `e` capacities."""
        poses = [_Node(np.eye(4)) for _ in range(n)]
        for k, p in enumerate(poses):
            p.transform[0, 3] = 0.1 * k
        step = np.eye(4)
        step[0, 3] = 0.1
        rels = [(k % (n - 1), k % (n - 1) + 1, step, np.eye(6)) for k in range(e)]
        optimize_se3(self.reflector._pack(poses, rels, 0), iters=iters, cg_iters=cg_iters, precond="chain")

    def finish(self):
        """The final map solve; returns its chi2."""
        chi2, _ = self.solve(FINAL_ITERS, FINAL_CG_ITERS)
        return chi2
