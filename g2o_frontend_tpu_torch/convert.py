"""State carried between the JAX package and the port.

The PWN path has no weights: its state is clouds, configs, poses, pose
graphs, maps, merged models and plane sets. Clouds, `PoseGraph2D`s,
`PoseGraph3D`s, `MergedModel`s and `PlaneSet`s cross as dicts of numpy
arrays keyed by their field names (the two packages share names and
layouts); configs cross as any object with the port config's fields, JAX's
included, read by attribute so that JAX is never imported. The slice-5 graphs
(`LineGraph`, `PlaneGraph`, `BAProblem`) cross as the JAX package's padded
arrays, padding and all (`line_graph_from_numpy`, ...): the port's
builders pad alike, and a likelihood map with its `GridSpec` through
`likelihood_map_from_numpy`. A `MapManager`
crosses through the checkpoint archive that both packages read and write
(`io.checkpoint.save_map` / `load_map`), any NamedTuple or dataclass of
arrays through `io.checkpoint.save_pytree` / `load_pytree`, and a cloud the
JAX package wrote as a reference `.pwn` file through
`pwn.cloud_io.cloud_from_pwn` (the two packages' files are byte-equal). A
`G2OLog` crosses as itself: the port's `io/g2o.py` is a copy of JAX's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph.store import PoseGraph2D, PoseGraph3D
from .laser.scan_matcher import GridSpec
from .pwn.aligner import AlignerConfig
from .pwn.cloud import Cloud
from .pwn.converter import ConverterConfig
from .pwn.merger import MergedModel
from .pwn.planes import PlaneSet
from .pwn.projector import PinholeProjector
from .slam.map_closer import CloserConfig
from .solvers.ba import BAProblem
from .solvers.line_slam import LineGraph
from .solvers.plane_slam import PlaneGraph

_CONFIGS = (PinholeProjector, ConverterConfig, AlignerConfig, CloserConfig)


def cloud_from_numpy(arrays, device="cuda") -> Cloud:
    """{field: array} (e.g. a JAX Cloud's ``_asdict()`` through numpy) -> Cloud
    on `device`; `valid` becomes bool, every other field float32."""
    return Cloud(**_bool_or_f32(Cloud._fields, arrays, device, ("valid",)))


def cloud_to_numpy(cloud: Cloud) -> dict:
    """Cloud -> {field: numpy array} on the host."""
    return {name: getattr(cloud, name).detach().cpu().numpy() for name in Cloud._fields}


def _bool_or_f32(fields, arrays, device, bool_fields):
    return {
        name: torch.as_tensor(np.array(arrays[name], bool if name in bool_fields else np.float32), device=device)
        for name in fields
    }


def merged_model_from_numpy(arrays, device="cuda") -> MergedModel:
    """{field: array} (e.g. a JAX MergedModel's ``_asdict()`` through numpy)
    -> MergedModel on `device`; `mask` becomes bool, the rest float32."""
    return MergedModel(**_bool_or_f32(MergedModel._fields, arrays, device, ("mask",)))


def plane_set_from_numpy(arrays, device="cuda") -> PlaneSet:
    """{field: array} (e.g. a JAX PlaneSet's ``_asdict()`` through numpy) ->
    PlaneSet on `device`; `mask` becomes bool, the rest float32."""
    return PlaneSet(**_bool_or_f32(PlaneSet._fields, arrays, device, ("mask",)))


def _pose_graph_from_numpy(cls, arrays, device):
    """Masks and `fixed` bool, edge indices int64, the rest float32."""

    def field(name):
        a = np.asarray(arrays[name])
        dtype = bool if name.endswith("mask") or name == "fixed" else np.int64 if name.endswith("_ij") else np.float32
        return torch.as_tensor(np.array(a, dtype), device=device)

    names = cls._fields if hasattr(cls, "_fields") else [f.name for f in dataclasses.fields(cls)]
    return cls(**{name: field(name) for name in names})


def pose_graph3d_from_numpy(arrays, device="cuda") -> PoseGraph3D:
    """{field: array} (e.g. a JAX PoseGraph3D's fields through numpy) ->
    PoseGraph3D on `device`: masks bool, indices int64, the rest float32."""
    return _pose_graph_from_numpy(PoseGraph3D, arrays, device)


def pose_graph3d_to_numpy(g: PoseGraph3D) -> dict:
    """PoseGraph3D -> {field: numpy array} on the host."""
    return {f.name: getattr(g, f.name).detach().cpu().numpy() for f in dataclasses.fields(PoseGraph3D)}


def pose_graph2d_from_numpy(arrays, device="cuda") -> PoseGraph2D:
    """{field: array} (e.g. a JAX PoseGraph2D's fields through numpy, padded
    or not) -> PoseGraph2D on `device`: masks and `fixed` bool, `pp_ij` and
    `pl_ij` int64, the rest float32."""
    return _pose_graph_from_numpy(PoseGraph2D, arrays, device)


def pose_graph2d_to_numpy(g: PoseGraph2D) -> dict:
    """PoseGraph2D -> {field: numpy array} on the host."""
    return {f.name: getattr(g, f.name).detach().cpu().numpy() for f in dataclasses.fields(PoseGraph2D)}


def _to_numpy(tup) -> dict:
    return {name: t.detach().cpu().numpy() for name, t in tup._asdict().items()}


def line_graph_from_numpy(arrays, device="cuda") -> LineGraph:
    """{field: array} of a JAX LineGraph (padded to powers of two) -> the
    port's LineGraph on `device`, padded alike."""
    return _pose_graph_from_numpy(LineGraph, arrays, device)


def line_graph_to_numpy(g: LineGraph) -> dict:
    """LineGraph -> {field: numpy array} on the host."""
    return _to_numpy(g)


def plane_graph_from_numpy(arrays, device="cuda") -> PlaneGraph:
    """{field: array} of a JAX PlaneGraph (padded) -> the port's PlaneGraph
    on `device`, padded alike."""
    return _pose_graph_from_numpy(PlaneGraph, arrays, device)


def plane_graph_to_numpy(g: PlaneGraph) -> dict:
    """PlaneGraph -> {field: numpy array} on the host."""
    return _to_numpy(g)


def ba_problem_from_numpy(arrays, device="cuda") -> BAProblem:
    """{field: array} of a JAX BAProblem (padded) -> the port's BAProblem on
    `device`, padded alike."""
    return _pose_graph_from_numpy(BAProblem, arrays, device)


def ba_problem_to_numpy(ba: BAProblem) -> dict:
    """BAProblem -> {field: numpy array} on the host."""
    return _to_numpy(ba)


def likelihood_map_from_numpy(grid, spec, device="cuda"):
    """A JAX likelihood map (as numpy) and any object with a GridSpec's
    fields (JAX's included) -> (float32 (H, W) tensor on `device`, the
    port's GridSpec)."""
    names = [f.name for f in dataclasses.fields(GridSpec)]
    port_spec = GridSpec(**{n: getattr(spec, n) for n in names})
    return torch.as_tensor(np.array(grid, np.float32), device=device), port_spec


def config_from(obj):
    """The port's PinholeProjector, ConverterConfig, AlignerConfig or CloserConfig with the
    field values of `obj`: the first config class all of whose fields `obj`
    has as attributes."""
    for cls in _CONFIGS:
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(obj, n) for n in names):
            return cls(**{n: getattr(obj, n) for n in names})
    raise TypeError(f"{type(obj).__name__} has the fields of none of {[c.__name__ for c in _CONFIGS]}")
