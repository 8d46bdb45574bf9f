"""Map checkpoints as npz archives (counterpart of `save_map` / `load_map`
in ``g2o_frontend_tpu/io/checkpoint.py``).

A `MapManager` (nodes, levels, payloads, relations, consensus counters) is
packed to arrays plus a small JSON header, in the JAX package's archive
layout, so that a map saved by either package loads in the other. The
reference checkpoints by serializing its object graph through boss at
shutdown (``pwn_slam_app.cpp:124-130``). `save_pytree` / `load_pytree`
wait for a later slice.
"""
from __future__ import annotations

import json

import numpy as np

from ..graph.map_manager import MapManager, MapRelation


def save_map(path, manager: MapManager):
    """Serialize a MapManager (nodes, relations, consensus state)."""
    if not isinstance(manager, MapManager):
        raise TypeError(f"save_map takes a MapManager, got {type(manager).__name__}")
    nodes_T = np.stack([n.transform for n in manager.nodes]) if manager.nodes else np.zeros((0, 4, 4))
    levels = np.asarray([n.level for n in manager.nodes], np.int32)
    payloads = [n.payload for n in manager.nodes]
    rel_rows, rel_T, rel_I = [], [], []
    for r in manager.relations:
        rel_rows.append([
            r.node_from.seq, r.node_to.seq, int(r.is_closure), int(r.accepted),
            r.consensus_times_checked, r.consensus_cum_inlier, r.consensus_cum_outlier_times,
        ])
        rel_T.append(r.transform)
        rel_I.append(r.information)
    header = json.dumps({"payloads": payloads})
    np.savez_compressed(
        path,
        nodes_T=nodes_T,
        levels=levels,
        rel_rows=np.asarray(rel_rows, np.int64).reshape(-1, 7),
        rel_T=np.asarray(rel_T).reshape(-1, 4, 4),
        rel_I=np.asarray(rel_I).reshape(-1, 6, 6),
        header=np.frombuffer(header.encode(), np.uint8),
    )


def load_map(path) -> MapManager:
    """Rebuild the MapManager that `save_map` wrote (either package's)."""
    data = np.load(path)
    header = json.loads(bytes(data["header"]).decode())
    mgr = MapManager()
    for T, lvl, pl in zip(data["nodes_T"], data["levels"], header["payloads"]):
        mgr.add_node(T, payload=pl, level=int(lvl))
    for row, T, I in zip(data["rel_rows"], data["rel_T"], data["rel_I"]):
        mgr.add_relation(MapRelation(
            node_from=mgr.nodes[int(row[0])],
            node_to=mgr.nodes[int(row[1])],
            transform=T,
            information=I,
            is_closure=bool(row[2]),
            accepted=bool(row[3]),
            consensus_times_checked=int(row[4]),
            consensus_cum_inlier=int(row[5]),
            consensus_cum_outlier_times=int(row[6]),
        ))
    return mgr
