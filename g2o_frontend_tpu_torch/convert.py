"""State carried between the JAX package and the port.

The PWN path has no weights: its state is clouds, configs, poses, pose
graphs and maps. Clouds and `PoseGraph3D`s cross as dicts of numpy arrays
keyed by their field names (the two packages share names and layouts);
configs cross as any object with the port config's fields, JAX's included,
read by attribute so that JAX is never imported. A `MapManager` crosses
through the checkpoint archive that both packages read and write
(`io.checkpoint.save_map` / `load_map`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph.store import PoseGraph3D
from .pwn.aligner import AlignerConfig
from .pwn.cloud import Cloud
from .pwn.converter import ConverterConfig
from .pwn.projector import PinholeProjector
from .slam.map_closer import CloserConfig

_CONFIGS = (PinholeProjector, ConverterConfig, AlignerConfig, CloserConfig)


def cloud_from_numpy(arrays, device="cpu") -> Cloud:
    """{field: array} (e.g. a JAX Cloud's ``_asdict()`` through numpy) -> Cloud
    on `device`; `valid` becomes bool, every other field float32."""
    return Cloud(
        **{
            name: torch.as_tensor(np.array(arrays[name], bool if name == "valid" else np.float32), device=device)
            for name in Cloud._fields
        }
    )


def cloud_to_numpy(cloud: Cloud) -> dict:
    """Cloud -> {field: numpy array} on the host."""
    return {name: getattr(cloud, name).detach().cpu().numpy() for name in Cloud._fields}


def pose_graph3d_from_numpy(arrays, device="cpu") -> PoseGraph3D:
    """{field: array} (e.g. a JAX PoseGraph3D's fields through numpy) ->
    PoseGraph3D on `device`: masks bool, indices int64, the rest float32."""

    def field(name):
        a = np.asarray(arrays[name])
        dtype = bool if name.endswith("mask") or name == "fixed" else np.int64 if name == "pp_ij" else np.float32
        return torch.as_tensor(np.array(a, dtype), device=device)

    return PoseGraph3D(**{f.name: field(f.name) for f in dataclasses.fields(PoseGraph3D)})


def pose_graph3d_to_numpy(g: PoseGraph3D) -> dict:
    """PoseGraph3D -> {field: numpy array} on the host."""
    return {f.name: getattr(g, f.name).detach().cpu().numpy() for f in dataclasses.fields(PoseGraph3D)}


def config_from(obj):
    """The port's PinholeProjector, ConverterConfig, AlignerConfig or CloserConfig with the
    field values of `obj`: the first config class all of whose fields `obj`
    has as attributes."""
    for cls in _CONFIGS:
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(obj, n) for n in names):
            return cls(**{n: getattr(obj, n) for n in names})
    raise TypeError(f"{type(obj).__name__} has the fields of none of {[c.__name__ for c in _CONFIGS]}")
