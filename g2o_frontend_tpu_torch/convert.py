"""State carried between the JAX package and the port.

The odometry path has no weights: its state is clouds, configs and poses.
Clouds cross as dicts of numpy arrays keyed by the `Cloud` field names (the
two packages share names and channel-planar layouts); configs cross as any
object with the port config's fields, JAX's included, read by attribute so
that JAX is never imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pwn.aligner import AlignerConfig
from .pwn.cloud import Cloud
from .pwn.converter import ConverterConfig
from .pwn.projector import PinholeProjector

_CONFIGS = (PinholeProjector, ConverterConfig, AlignerConfig)


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


def config_from(obj):
    """The port's PinholeProjector, ConverterConfig or AlignerConfig with the
    field values of `obj`: the first config class all of whose fields `obj`
    has as attributes."""
    for cls in _CONFIGS:
        names = [f.name for f in dataclasses.fields(cls)]
        if all(hasattr(obj, n) for n in names):
            return cls(**{n: getattr(obj, n) for n in names})
    raise TypeError(f"{type(obj).__name__} has the fields of none of {[c.__name__ for c in _CONFIGS]}")
