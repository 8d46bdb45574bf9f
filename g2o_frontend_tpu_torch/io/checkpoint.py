"""Checkpoints as npz archives (counterpart of
``g2o_frontend_tpu/io/checkpoint.py``).

- `save_pytree` / `load_pytree`: a NamedTuple or dataclass of tensors
  (`Cloud`, `MergedModel`, `PlaneSet`, `PoseGraph3D`, nested, in lists,
  tuples or dicts) as one compressed npz. Leaves are stored as ``leaf_{i}``
  in the order JAX's ``tree_flatten`` gives them (fields in order, dict keys
  sorted, None no leaf), so a file written by either package loads in the
  other.
- `save_map` / `load_map`: a `MapManager` (nodes, levels, payloads,
  relations, consensus counters) packed to arrays plus a small JSON header,
  in the JAX package's archive layout.

The reference checkpoints by serializing its object graph through boss at
shutdown (``pwn_slam_app.cpp:124-130``).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..graph.map_manager import MapManager, MapRelation


def _children(tree):
    """The sub-trees of a node in JAX's flatten order, or None for a leaf."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return list(tree)
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    return None


def _leaves(tree):
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in _leaves(kid)]


def _rebuild(example, leaves):
    """`example`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    kids = _children(example)
    if kids is None:
        return next(leaves)
    if example is None:
        return None
    new = [_rebuild(kid, leaves) for kid in kids]
    if isinstance(example, dict):
        return dict(zip(sorted(example), new))
    if hasattr(example, "_fields"):  # NamedTuple
        return type(example)(*new)
    if isinstance(example, (tuple, list)):
        return type(example)(new)
    return dataclasses.replace(example, **{f.name: x for f, x in zip(dataclasses.fields(example), new)})


def save_pytree(path, tree):
    """Save a NamedTuple/dataclass-like tree of tensors to npz."""
    leaves = _leaves(tree)
    arrs = {f"leaf_{i}": (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x))
            for i, x in enumerate(leaves)}
    arrs["__treedef__"] = np.frombuffer(f"{type(tree).__name__}, {len(leaves)} leaves".encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrs)


def load_pytree(path, example):
    """Load into the structure of `example` (shapes may differ): each leaf
    becomes a tensor with the dtype and on the device of the example's
    leaf where that is a tensor, else as stored, on the CPU."""
    data = np.load(path)

    def leaf(i, like):
        x = torch.from_numpy(np.array(data[f"leaf_{i}"]))
        return x.to(dtype=like.dtype, device=like.device) if torch.is_tensor(like) else x

    return _rebuild(example, iter([leaf(i, x) for i, x in enumerate(_leaves(example))]))


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
