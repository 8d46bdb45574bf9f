"""Deterministic segment sums: the port's ``jax.ops.segment_sum``.

The JAX package sums per-edge terms into per-vertex rows with
``jax.ops.segment_sum`` (an XLA operation, not a Pallas kernel). A float
``index_add_`` does the same in PyTorch, but on CUDA it is an atomicAdd per
element whose order changes from run to run, and so do the LM solvers that
assemble their gradients, diagonal blocks and Hessian-vector products with
it. Here the order is the port's own:

- `SegmentIndex` is built once from an index (E,) and a segment count n:
  a stable argsort `order` (int32) and `offsets` (n + 1,) (int32), the
  start of each segment in that order. An index may hold n itself, the
  dump slot of rows that go nowhere (the PWN sums scatter invalid rows
  there); empty segments sum to 0. On a CUDA index both are built at once
  (one sort per index, not per sum); on a CPU index only when read.
- `segment_sum(values, seg)` sums values (E,) or (E, ...) in float32 or
  float64 into (n,) or (n, ...). On a CUDA tensor it launches the
  hand-written kernel ``csrc/segment_sum.cu`` (or raises): one thread per
  (segment, column) adding the segment's rows in their original order, so
  two launches agree bit for bit and equal the CPU's ``index_add_`` on the
  same inputs. On a CPU tensor it takes `segment_sum_reference`. It counts
  its kernel launches in `launches`.
- `segment_sum_reference` is the plain version: ``index_add_`` into zeros,
  the rows of the dump slot dropped.
- `compact_index(index)` is a `SegmentIndex` over the distinct values of an
  index with a large range (the dense Hessian's flat (D * D) index), with
  those values: sum into the compact rows, then write them in place.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches made by `segment_sum` on CUDA tensors since the last reset
launches = 0

SOURCE = cuda_build.CSRC / "segment_sum.cu"
_lib = None


class SegmentIndex:
    """A segment index (E,) over n segments (n the dump slot), with the
    stable order of its rows and each segment's offsets in that order."""

    __slots__ = ("index", "n", "_order", "_offsets")

    def __init__(self, index: torch.Tensor, n: int):
        self.index = index.reshape(-1)
        self.n = int(n)
        self._order = self._offsets = None
        if self.index.is_cuda:
            self._build()

    def _build(self):
        if self.index.numel() >= 2**31 or self.n >= 2**31 - 1:
            raise ValueError(f"segment index of {self.index.numel()} rows into {self.n} segments exceeds int32")
        sorted_index, order = torch.sort(self.index, stable=True)
        bounds = torch.arange(self.n + 1, dtype=sorted_index.dtype, device=sorted_index.device)
        self._order = order.to(torch.int32)
        self._offsets = torch.searchsorted(sorted_index, bounds, out_int32=True)

    @property
    def order(self) -> torch.Tensor:
        if self._order is None:
            self._build()
        return self._order

    @property
    def offsets(self) -> torch.Tensor:
        if self._offsets is None:
            self._build()
        return self._offsets

    @property
    def device(self) -> torch.device:
        return self.index.device


def compact_index(index: torch.Tensor):
    """(ids, seg): the sorted distinct values of `index` and the
    `SegmentIndex` of each row's position among them."""
    ids, inverse = torch.unique(index.reshape(-1), sorted=True, return_inverse=True)
    return ids, SegmentIndex(inverse, ids.numel())


def segment_sum_reference(values: torch.Tensor, seg: SegmentIndex) -> torch.Tensor:
    """The plain PyTorch version: ``index_add_`` into n + 1 zero rows, the
    dump slot's row dropped."""
    out = values.new_zeros((seg.n + 1,) + values.shape[1:])
    return out.index_add_(0, seg.index, values)[: seg.n]


def build():
    """Compile ``csrc/segment_sum.cu`` unless that build exists. Returns
    (library path, seconds spent compiling, nvcc's diagnostics)."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ("segment_sum_f32_launch", "segment_sum_f64_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_LAUNCH = {torch.float32: "segment_sum_f32_launch", torch.float64: "segment_sum_f64_launch"}


def segment_sum(values: torch.Tensor, seg: SegmentIndex) -> torch.Tensor:
    """values (E, ...) summed over `seg`'s segments -> (n, ...).

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `segment_sum_reference`."""
    global launches
    if values.shape[0] != seg.index.shape[0]:
        raise ValueError(f"{values.shape[0]} rows of values for a segment index of {seg.index.shape[0]}")
    dev = values.device
    if dev.type == "cpu":
        return segment_sum_reference(values, seg)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on CPU or CUDA tensors, got {dev}")
    if values.dtype not in _LAUNCH:
        raise ValueError(f"segment_sum sums float32 or float64, got {values.dtype}")
    if seg.device != dev:
        raise ValueError(f"the segment index is on {seg.device}, the values on {dev}")
    tail = values.shape[1:]
    C = 1
    for d in tail:
        C *= d
    out = torch.empty((seg.n,) + tail, dtype=values.dtype, device=dev)
    if seg.n * C == 0:
        return out
    if C >= 2**31:
        raise ValueError(f"{C} columns exceed the kernel's int32 range")
    v = values.reshape(values.shape[0], C).contiguous()
    order, offsets = seg.order, seg.offsets
    fn = getattr(_load(), _LAUNCH[values.dtype])
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(), seg.n, C,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    launches += 1
    return out
