"""Map-level merger: keyframe grouping + redundancy collapse (counterpart of
``g2o_frontend_tpu/slam/map_merger.py``).

Re-design of ``boss_map_building/map_merger.{h,cpp}`` (MapMerger: every
`listSize` incoming key nodes become one "big node" linked to the previous
big node, ``map_merger.cpp:43-115``) and the goal of
``pwn_tracker2/merger2.h:20`` (collapse redundant map content when the
trajectory revisits mapped space).

- `process_key_node`: group every `list_size` key nodes, lift the group's
  first node one level (MapNodeAlias), chain consecutive big nodes with
  the reference's fixed information (diag 10/100,
  ``map_merger.cpp:106-109``). Level-1 nodes give
  `MapReflector.optimize_hierarchical` its coarse layer.
- `collapse_redundant`: keyframe pairs joined by an ACCEPTED closure whose
  optimized poses coincide within the gates describe the same place; the
  newer node is retired and its relations are re-targeted onto the
  survivor with the proper transform composition. With a `cloud_cache`,
  the retired node's cloud is fused into the survivor's cache entry
  through ``pwn/merger.py`` (the Merger2 depth collapse,
  ``merger2.h:33-35``), on the cache's device.

Retired nodes keep their seq slot but carry no relations and are flagged
``payload["merged_into"]``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.map_manager import MapManager, MapNode, MapRelation
from ..pwn.merger import MergedModel, MergerConfig, add_cloud, collapse, empty_model


def fuse_clouds(keep_cloud, drop_cloud, transform, projector) -> tuple[torch.Tensor, MergedModel]:
    """The Merger2 depth collapse of two clouds: both in one model of twice
    a cloud's pixels, `drop_cloud` mapped by the 4x4 `transform` (keep <-
    drop), collapsed in the keep view with the default `MergerConfig`, and
    the surviving points rendered by `projector`. Returns (fused depth
    (H, W), the collapsed model)."""
    model = empty_model(2 * keep_cloud.valid.numel(), dtype=keep_cloud.p.dtype, device=keep_cloud.p.device)
    model = add_cloud(add_cloud(model, keep_cloud), drop_cloud, transform)
    fused = collapse(model, projector, config=MergerConfig())
    depth, _ = projector.project(fused.points, fused.mask)
    return depth, fused


class MapMerger:
    def __init__(self, manager: MapManager, list_size: int = 5, cloud_cache=None):
        self.manager = manager
        self.list_size = list_size
        self.cache = cloud_cache
        self._group: list[MapNode] = []
        self._last_big: MapNode | None = None
        self.merged_pairs: list[tuple[int, int]] = []  # (kept, dropped)

    # -- stream grouping (map_merger.cpp:43-115) -----------------------------
    def process_key_node(self, node: MapNode):
        """Feed one key node; every `list_size` nodes emit a level-1 big
        node (alias of the group's first) + the relation chaining it to the
        previous big node. Returns the new big node or None."""
        self._group.append(node)
        if len(self._group) <= self.list_size:
            return None
        first = self._group[0]
        self._group = []
        big = self.manager.add_alias(first)
        if self._last_big is not None:
            T = np.linalg.inv(self._last_big.transform) @ big.transform
            info = np.eye(6)
            info[:3, :3] *= 10.0
            info[3:, 3:] *= 100.0  # map_merger.cpp:106-109
            self.manager.add_relation(MapRelation(self._last_big, big, T, info))
        self._last_big = big
        return big

    # -- redundancy collapse --------------------------------------------------
    def collapse_redundant(
        self,
        translational_threshold: float = 0.25,
        rotational_threshold: float = 0.25,
        level: int = 0,
    ) -> int:
        """Retire keyframes that duplicate an older keyframe's pose.

        A pair qualifies when an ACCEPTED closure relation joins it and the
        optimized relative pose is within the gates. The younger node's
        relations are re-targeted onto the older one:

          rel (D -> x, T)  becomes  (K -> x, X @ T)   with X = K^-1 D
          rel (x -> D, T)  becomes  (x -> K, T @ X^-1)

        (transforms map `to`-coordinates into the `from` frame); relations
        that become self-loops are dropped. Returns the number of retired
        nodes. Idempotent: retired nodes never match again.
        """
        merged = 0
        for rel in list(self.manager.relations):
            if not (rel.is_closure and rel.accepted):
                continue
            a, b = rel.node_from, rel.node_to
            if a.level != level or b.level != level:
                continue
            if a.payload.get("merged_into") is not None or b.payload.get("merged_into") is not None:
                continue
            err = np.linalg.inv(a.transform) @ b.transform
            dt = float(np.linalg.norm(err[:3, 3]))
            dr = float(np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)))
            if dt > translational_threshold or dr > rotational_threshold:
                continue
            keep, drop = (a, b) if a.seq <= b.seq else (b, a)
            self._retarget(keep, drop)
            if self.cache is not None:
                self._fuse_clouds(keep, drop)
            drop.payload["merged_into"] = keep.seq
            self.merged_pairs.append((keep.seq, drop.seq))
            merged += 1
        return merged

    def _retarget(self, keep: MapNode, drop: MapNode):
        X = np.linalg.inv(keep.transform) @ drop.transform
        X_inv = np.linalg.inv(X)
        for r in list(self.manager.node_relations(drop)):
            self.manager.remove_relation(r)
            if r.node_from is drop and r.node_to is drop:
                continue
            if r.node_from is drop:
                if r.node_to is keep:
                    continue  # the closure being collapsed
                node_from, node_to, T = keep, r.node_to, X @ r.transform
            else:
                if r.node_from is keep:
                    continue
                node_from, node_to, T = r.node_from, keep, r.transform @ X_inv
            self.manager.add_relation(MapRelation(
                node_from=node_from, node_to=node_to, transform=T, information=r.information,
                is_closure=r.is_closure, accepted=r.accepted, payload=r.payload,
            ))

    def _fuse_clouds(self, keep: MapNode, drop: MapNode):
        """Merger2 role (``merger2.h:33-35``): depth-collapse the retired
        node's cloud into the survivor's view and store the fused depth back
        in the cache, which derives the survivor's cloud from it anew. A
        pair whose frames the cache does not hold is left unfused; a fusion
        that fails raises."""
        kf = keep.payload.get("frame")
        df = drop.payload.get("frame")
        if kf is None or df is None or kf not in self.cache or df not in self.cache:
            return
        keep_c = self.cache.get(kf)
        X = torch.as_tensor(np.linalg.inv(keep.transform) @ drop.transform, dtype=torch.float32,
                            device=keep_c.p.device)
        depth, _ = fuse_clouds(keep_c, self.cache.get(df), X, self.cache.projector)
        self.cache.put(kf, depth)
        self.cache._clouds.pop(kf, None)  # recompute the cloud from the fused depth

    def active_nodes(self, level: int = 0) -> list[MapNode]:
        return [n for n in self.manager.nodes if n.level == level and n.payload.get("merged_into") is None]
