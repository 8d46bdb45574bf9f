"""Map model: nodes, relations, criteria, partitions (boss_map analog).

Host-side re-design of ``boss_map``'s map layer:
- `MapNode` / `MapRelation` (``map_core.h`` MapNode, MapNodeBinaryRelation):
  SE3 pose nodes with seq numbers; binary relations carry a 4x4 transform,
  6x6 information, and the closure-consensus counters (`ClosureInfo`,
  ``map_closer.h:11-18``),
- `MapManager` (``map_manager.h:9-56``): bookkeeping + action handlers
  (nodeAdded/relationAdded callbacks used by the g2o reflector analog),
- `select_nodes` (``map_utils.cpp:119``): nodes accepted by a pose
  criterion (distance / gaze),
- `make_partitions` (``map_utils.cpp:167``): connected components of the
  selected set under a relation selector — the structure reused by the
  distributed solver as its sharding axis (SURVEY.md §5).

Geometry math is numpy here (graphs are small); bulk per-node distance
checks go through one vectorized pass.

The port's own copy of ``g2o_frontend_tpu/graph/map_manager.py`` (numpy only): the
port imports nothing of the JAX package, so the two copies are kept equal
by hand.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class MapNode:
    seq: int
    transform: np.ndarray  # (4, 4) pose
    level: int = 0
    payload: dict = field(default_factory=dict)

    def __hash__(self):
        return self.seq

    def __eq__(self, other):
        return isinstance(other, MapNode) and other.seq == self.seq


class MapNodeAlias(MapNode):
    """A node at level+1 whose pose proxies an `original` node
    (``map_core.h`` MapNodeAlias, ``:79-99``) — the reference's mechanism
    for hierarchical map levels: higher levels alias representative nodes of
    lower-level partitions, so level-L optimization moves whole subtrees."""

    def __init__(self, seq: int, original: MapNode, payload=None):
        super().__init__(seq=seq, transform=original.transform,
                         level=original.level + 1, payload=payload or {})
        self.original = original

    @property  # type: ignore[override]
    def transform(self):
        return self.original.transform

    @transform.setter
    def transform(self, value):
        # setting an alias pose moves the original (map_core.h:90-92)
        if getattr(self, "original", None) is not None:
            self.original.transform = value


@dataclass
class MapRelation:
    """Binary relation; transform maps `to` coordinates into `from` frame."""

    node_from: MapNode
    node_to: MapNode
    transform: np.ndarray  # (4, 4)
    information: np.ndarray  # (6, 6)
    # ClosureInfo consensus fields (map_closer.h:11-18)
    is_closure: bool = False
    accepted: bool = False
    consensus_times_checked: int = 0
    consensus_cum_inlier: int = 0
    consensus_cum_outlier_times: int = 0
    payload: dict = field(default_factory=dict)

    # identity semantics: relations are graph OBJECTS. The dataclass-
    # generated field __eq__ compares numpy arrays (ambiguous truth) the
    # moment `rel in relations` misses the identical object — hash was
    # already id-based, eq must match it.
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


class PoseAcceptanceCriterion:
    """Pluggable node-acceptance criteria (``map_utils.h:10-108``).

    `set_reference_pose` fixes the query pose; `accept_mask` evaluates a
    stack of (N, 4, 4) node poses in one vectorized pass (the reference
    calls per-node ``accept``; same semantics, batched)."""

    def set_reference_pose(self, pose: np.ndarray):
        self.pose = np.asarray(pose, np.float64)
        self.inv_pose = np.linalg.inv(self.pose)

    def accept_mask(self, T: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class DistancePoseAcceptanceCriterion(PoseAcceptanceCriterion):
    """Planar translational + angular gate (``map_utils.cpp:69-84``; note
    the reference's own 'hack': the translational test uses only the x/y
    components of the relative translation — kept verbatim)."""

    def __init__(self, translational_distance=0.5, rotational_distance=0.5):
        self.td2 = translational_distance * translational_distance
        self.rd = rotational_distance

    def accept_mask(self, T):
        rel = np.einsum("ij,njk->nik", self.inv_pose, T)
        dt2 = rel[:, 0, 3] ** 2 + rel[:, 1, 3] ** 2
        tr = np.clip((np.trace(rel[:, :3, :3], axis1=1, axis2=2) - 1) / 2,
                     -1, 1)
        return (dt2 < self.td2) & (np.arccos(tr) < self.rd)


class GazePointAcceptanceCriterion(PoseAcceptanceCriterion):
    """Accept nodes near AND facing the reference's gaze point — the point
    `forward_sliding` meters ahead of the reference pose along its x axis
    (``map_utils.cpp:34-48``): a node passes when the gaze point lies within
    `translational_distance` of it and within `rotational_distance` of its
    own viewing direction (column 0 of its rotation)."""

    def __init__(self, translational_distance=0.5, rotational_distance=0.5,
                 forward_sliding=1.0):
        self.td2 = translational_distance * translational_distance
        self.rd = rotational_distance
        self.fs = forward_sliding

    def set_reference_pose(self, pose):
        super().set_reference_pose(pose)
        slide = np.eye(4)
        slide[0, 3] = self.fs
        self.gaze = self.pose @ slide  # _pose2

    def accept_mask(self, T):
        rel_t = np.einsum(
            "ij,nj->ni", self.inv_pose[:3, :3], T[:, :3, 3]
        ) + self.inv_pose[:3, 3]
        at_ref = np.sum(rel_t**2, -1) == 0  # the reference node itself
        v1 = T[:, :3, 0]  # node viewing direction
        v3 = self.gaze[:3, 3][None] - T[:, :3, 3]
        near = np.sum(v3**2, -1) <= self.td2
        # angle between v3 and v1 (FromTwoVectors rotation angle)
        cos_a = np.sum(v1 * v3, -1) / np.maximum(
            np.linalg.norm(v1, axis=-1) * np.linalg.norm(v3, axis=-1), 1e-12
        )
        facing = np.abs(np.arccos(np.clip(cos_a, -1, 1))) <= self.rd
        return at_ref | (near & facing)


class MahalanobisPoseAcceptanceCriterion(PoseAcceptanceCriterion):
    """6-DOF chart-space Mahalanobis gate (``map_utils.cpp:100-116``)."""

    def __init__(self, information: np.ndarray, distance: float):
        self.info = np.asarray(information, np.float64)
        self.distance = distance

    def accept_mask(self, T):
        rel = np.einsum("ij,njk->nik", self.inv_pose, T)
        # t2v chart: translation + normalized quaternion imaginary part
        t = rel[:, :3, 3]
        R = rel[:, :3, :3]
        qw = np.sqrt(np.maximum(1.0 + np.trace(R, axis1=1, axis2=2), 1e-12)) / 2
        qx = (R[:, 2, 1] - R[:, 1, 2]) / (4 * qw)
        qy = (R[:, 0, 2] - R[:, 2, 0]) / (4 * qw)
        qz = (R[:, 1, 0] - R[:, 0, 1]) / (4 * qw)
        v = np.concatenate([t, np.stack([qx, qy, qz], -1)], -1)
        d = np.einsum("ni,ij,nj->n", v, self.info, v)
        return d < self.distance


class MapManager:
    """Node/relation bookkeeping with observer callbacks."""

    def __init__(self):
        self.nodes: list[MapNode] = []
        self.relations: list[MapRelation] = []
        self._node_relations: dict[int, set[MapRelation]] = {}
        self.node_added_handlers: list[Callable] = []
        self.relation_added_handlers: list[Callable] = []
        self.relation_removed_handlers: list[Callable] = []

    def add_node(self, transform, payload=None, level=0) -> MapNode:
        n = MapNode(seq=len(self.nodes), transform=np.asarray(transform, np.float64),
                    level=level, payload=payload or {})
        self.nodes.append(n)
        self._node_relations[n.seq] = set()
        for h in self.node_added_handlers:
            h(n)
        return n

    def add_alias(self, original: MapNode, payload=None) -> MapNodeAlias:
        """Lift `original` one level up (``map_core.h`` MapNodeAlias)."""
        n = MapNodeAlias(seq=len(self.nodes), original=original,
                         payload=payload)
        self.nodes.append(n)
        self._node_relations[n.seq] = set()
        for h in self.node_added_handlers:
            h(n)
        return n

    def level_nodes(self, level: int) -> list[MapNode]:
        return [n for n in self.nodes if n.level == level]

    def add_relation(self, rel: MapRelation) -> MapRelation:
        self.relations.append(rel)
        self._node_relations[rel.node_from.seq].add(rel)
        self._node_relations[rel.node_to.seq].add(rel)
        for h in self.relation_added_handlers:
            h(rel)
        return rel

    def remove_relation(self, rel: MapRelation):
        if rel in self.relations:
            self.relations.remove(rel)
            self._node_relations[rel.node_from.seq].discard(rel)
            self._node_relations[rel.node_to.seq].discard(rel)
            for h in self.relation_removed_handlers:
                h(rel)

    def node_relations(self, node: MapNode) -> set:
        return self._node_relations.get(node.seq, set())

    # -- criteria & partitions ---------------------------------------------
    def select_nodes(
        self,
        reference_pose: np.ndarray,
        translational_distance: float,
        rotational_distance: float = np.inf,
    ) -> list[MapNode]:
        """DistancePoseAcceptanceCriterion (``map_utils.h:62``) vectorized."""
        crit = DistancePoseAcceptanceCriterion(
            translational_distance, rotational_distance
        )
        crit.set_reference_pose(reference_pose)
        return self.select_nodes_by(crit)

    def select_nodes_by(self, criterion: "PoseAcceptanceCriterion"
                        ) -> list[MapNode]:
        """``selectNodes`` (``map_utils.cpp:119``): flat scan of every map
        node through a pluggable criterion — the closer's candidate source
        (spatial proximity regardless of graph connectivity; closures are
        exactly the relations that do NOT exist yet)."""
        if not self.nodes:
            return []
        T = np.stack([n.transform for n in self.nodes])
        ok = criterion.accept_mask(T)
        return [n for n, o in zip(self.nodes, ok) if o]

    def select_nodes_connected(
        self,
        start: MapNode,
        criterion: "PoseAcceptanceCriterion",
        relation_selector: Optional[Callable[[MapRelation], bool]] = None,
    ) -> list[MapNode]:
        """Connectivity-limited selection: breadth-first search over accepted
        relations from `start`, expanding only nodes the criterion accepts.

        The reference composes this from ``selectNodes`` + the BFS of
        ``makePartitions`` (``map_utils.cpp:167``) restricted to the start
        node's component; doing the BFS directly touches O(local map) nodes
        per keyframe instead of scanning the whole map, and never leaks
        spatially-near but graph-unconnected nodes into a LOCAL map (those
        are closure candidates, not established neighbours)."""
        if start not in self.nodes:
            return []
        out = [start]
        seen = {start.seq}
        queue = [start]
        while queue:
            n = queue.pop(0)
            for r in self._node_relations.get(n.seq, ()):  # noqa: B020
                if relation_selector is not None and not relation_selector(r):
                    continue
                for other in (r.node_from, r.node_to):
                    if other.seq in seen:
                        continue
                    seen.add(other.seq)
                    if criterion.accept_mask(other.transform[None])[0]:
                        out.append(other)
                        queue.append(other)
        return out

    def make_partitions(
        self,
        selected: list[MapNode],
        relation_selector: Optional[Callable[[MapRelation], bool]] = None,
    ) -> list[list[MapNode]]:
        """Connected components of `selected` under accepted relations."""
        sel = {n.seq for n in selected}
        parent = {s: s for s in sel}

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for r in self.relations:
            if relation_selector is not None and not relation_selector(r):
                continue
            a, b = r.node_from.seq, r.node_to.seq
            if a in sel and b in sel:
                union(a, b)
        groups: dict[int, list[MapNode]] = {}
        for n in selected:
            groups.setdefault(find(n.seq), []).append(n)
        return list(groups.values())
