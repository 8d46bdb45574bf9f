"""Deterministic segment sums: the port's ``jax.ops.segment_sum``.

The JAX package sums per-edge terms into per-vertex rows with
``jax.ops.segment_sum`` (an XLA operation, not a Pallas kernel). A float
``index_add_`` does the same in PyTorch, but on CUDA it is an atomicAdd per
element whose order changes from run to run, and so do the LM solvers that
assemble their gradients, diagonal blocks and Hessian-vector products with
it. Here the order is the port's own:

- `SegmentIndex` is built once from an index (E,) and a segment count n:
  a stable argsort `order` (int32) and `offsets` (n + 1,) (int32), the
  start of each segment in that order; and, for the kernel's long path,
  `by_length` (n,) (int64), the segments longest first (ties in segment
  order), and `sorted_lengths` (n,) (int32), their lengths in that order.
  An index may hold n itself, the dump slot of rows that go nowhere (the
  PWN sums scatter invalid rows there); empty segments sum to 0. On a CUDA
  index all of it is built at once (two sorts and four other operations
  per index, not per sum) on the device, with no host read, so a build
  can be captured in a CUDA graph; on a CPU index only when read.
- `segment_sum(values, seg)` sums values (E,) or (E, ...) in float32 or
  float64 into (n,) or (n, ...). On a CUDA tensor it launches the
  hand-written kernel ``csrc/segment_sum.cu`` (or raises), one launch a
  sum with no host read, so it can be captured in a CUDA graph: long
  segments staged through shared memory by persistent blocks, short ones
  a thread per (segment, column), the split decided on the device from
  the index's lengths; every (segment, column) added by one thread in the
  rows' original order, so two launches agree bit for bit and equal the
  CPU's ``index_add_`` on the same inputs. On a CPU tensor it takes
  `segment_sum_reference`. It counts its kernel launches in `launches`.
- `layout` is the kernel's launch geometry (blocks of each path, chunk
  rows, copy width, shared memory), in Python so that the CPU tests reach
  it; `_load` checks its constants against the source's.
- `segment_sum_reference` is the plain version: ``index_add_`` into zeros,
  the rows of the dump slot dropped.
- `_segment_sum_previous` launches the previous design (one thread per
  (segment, column) over all segments), uncounted, only to time the
  kernel against it.
- `compact_index(index)` is a `SegmentIndex` over the distinct values of an
  index with a large range (the dense Hessian's flat (D * D) index), with
  those values: sum into the compact rows, then write them in place.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build

# kernel launches made by `segment_sum` on CUDA tensors since the last reset
launches = 0

SOURCE = cuda_build.CSRC / "segment_sum.cu"
_lib = None

# The kernel's geometry (csrc/segment_sum.cu, checked against its
# segment_sum_constants at load): 256 threads a block; long chunks of up to
# ROWS_PER_THREAD rows a thread, NSTAGE of them staged (their order entries
# NORD chunks ahead), after LONG_HEAD bytes of chunk records and the walk's
# state; MAX_SMEM bytes of dynamic shared memory a block at most
# (segment_sum_init).
THREADS = 256
ROWS_PER_THREAD = 2
NSTAGE = 3
NORD = 3
LONG_HEAD = (NSTAGE + 3) * 16 + 32
MAX_SMEM = 227 * 1024
# A segment of at least LONG_ROWS rows takes the long path (the short
# path's thread would walk it 8 rows at a time), unless more segments have
# LONG_ROWS rows than there are long blocks: then only those of MEDIUM_ROWS
# rows or more (a long block would walk the others one after another, where
# short-path threads walk them side by side). The kernel reads which rule
# holds from the index's lengths (the (G + 1)-th longest).
LONG_ROWS = 32
MEDIUM_ROWS = 128
# Bytes of rows a staged chunk holds: SMALL_STAGE while the short blocks are
# many (a block then stays under 28 KB, and 8 of them fit an SM), else
# BIG_STAGE, for more rows in flight.
SMALL_STAGE = 6144
BIG_STAGE = 16384
MANY_SHORT_BLOCKS_PER_SM = 2
# Long blocks: at most LONG_BLOCKS_PER_SM for each SM, and no more than
# the segments of LONG_ROWS rows the E rows can make.
LONG_BLOCKS_PER_SM = 4
# A sparse sum (no more rows than segments, the dump slot's included) of at
# least VECTOR_OUTPUTS outputs gives a short-path thread 16 bytes of
# outputs (4 float32 or 2 float64); any other, one output a thread.
VECTOR_OUTPUTS = 1 << 20
VECTOR_BYTES = 16
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """The kernel's grid for E rows of C columns into n segments: block b
    < `short_blocks` takes a `tile` of consecutive outputs,
    `outputs_per_thread` a thread, skipping those of long segments; the
    `long_blocks` after them, l = 0, 1, ..., take the long segments (list
    entries l, l + long_blocks, ... of `by_length` while they are long:
    `long_threshold`), in chunks of
    up to `rows_per_chunk` rows copied `copy_bytes` at a time into stages of
    `stage_bytes`. `smem` bytes of shared memory a block."""

    E: int
    n: int
    C: int
    itemsize: int
    long_blocks: int
    short_blocks: int
    outputs_per_thread: int
    long_min: int
    medium_min: int
    rows_per_chunk: int
    copy_bytes: int
    stage_bytes: int
    smem: int

    @property
    def tile(self) -> int:
        return THREADS * self.outputs_per_thread

    @property
    def blocks(self) -> int:
        return self.short_blocks + self.long_blocks


def _ceil_div(a, b):
    return -(-a // b)


def layout(E, n, C, itemsize, sms=132, align=16, vector_out=True) -> Layout:
    """The kernel's `Layout` for E rows of C columns of `itemsize` bytes
    into n segments on a card of `sms` SMs, the values' pointer aligned to
    `align` bytes and the output's to 16 (`vector_out`): a function of the
    shapes alone. The module's constants are read at the call.

    The long path needs C <= THREADS (one adding thread a column); without
    it every segment takes the short path (`long_min` and `medium_min`
    INT32_MAX). Raises ValueError for sizes beyond the kernel's int32
    indexing or grid."""
    if itemsize not in (4, 8):
        raise ValueError(f"the kernel sums float32 or float64, got {itemsize}-byte items")
    if not (0 <= E < 2**31 and 0 <= n < INT32_MAX and 1 <= C < 2**30):
        raise ValueError(f"{E} rows of {C} columns into {n} segments exceed the kernel's int32 range")
    total = n * C
    sparse = total >= VECTOR_OUTPUTS and E <= n
    V = VECTOR_BYTES // itemsize if vector_out and sparse else 1
    short_blocks = _ceil_div(total, THREADS * V)
    stage_target = SMALL_STAGE if short_blocks > MANY_SHORT_BLOCKS_PER_SM * sms else BIG_STAGE
    row_bytes = C * itemsize
    G = min(n, E // LONG_ROWS, LONG_BLOCKS_PER_SM * sms) if C <= THREADS else 0
    if G > 0:
        W = next(w for w in (16, 8, 4) if w >= itemsize and row_bytes % w == 0 and align % w == 0)
        R = min(THREADS * ROWS_PER_THREAD, max(1, stage_target // row_bytes))
        stage = _ceil_div(R * row_bytes, 16) * 16
        long_min, medium_min = LONG_ROWS, max(LONG_ROWS, MEDIUM_ROWS)
        long_smem = LONG_HEAD + _ceil_div(NORD * R * 4, 16) * 16 + NSTAGE * stage
    else:
        W = R = stage = long_smem = 0
        long_min = medium_min = INT32_MAX
    if short_blocks + G > INT32_MAX:
        raise ValueError(f"{total} outputs exceed the kernel's grid")
    if long_smem > MAX_SMEM:
        raise ValueError(f"{long_smem} B of shared memory a block exceed the kernel's {MAX_SMEM}")
    return Layout(E, n, C, itemsize, G, short_blocks, V, long_min, medium_min, R, W, stage, long_smem)


def long_threshold(lengths_by_length, lay: Layout) -> int:
    """The rows from which a segment takes the kernel's long path, as the
    kernel decides it (csrc/segment_sum.cu's long_threshold): `long_min`,
    or `medium_min` where more segments have `long_min` rows than there
    are long blocks. `lengths_by_length` is the segments' lengths longest
    first (`SegmentIndex.sorted_lengths`); reading it is a host read, for
    the CPU model and reports."""
    G = lay.long_blocks
    if G == 0:
        return lay.long_min
    return lay.medium_min if G < lay.n and int(lengths_by_length[G]) >= lay.long_min else lay.long_min


class SegmentIndex:
    """A segment index (E,) over n segments (n the dump slot), with the
    stable order of its rows, each segment's offsets in that order, and the
    segments by length for the kernel's long path."""

    __slots__ = ("index", "n", "_order", "_offsets", "_by_length", "_sorted_lengths")

    def __init__(self, index: torch.Tensor, n: int):
        self.index = index.reshape(-1)
        self.n = int(n)
        self._order = self._offsets = self._by_length = self._sorted_lengths = None
        if self.index.is_cuda:
            self._build()

    def __tree_flatten__(self):
        """(n, the index and its built tensors): a node of `utils.graphs`'
        trees, so that a captured graph reads an index from static buffers."""
        return self.n, (self.index, self._order, self._offsets, self._by_length, self._sorted_lengths)

    @classmethod
    def __tree_unflatten__(cls, n, children):
        seg = cls.__new__(cls)
        seg.n = n
        seg.index, seg._order, seg._offsets, seg._by_length, seg._sorted_lengths = children
        return seg

    def _build(self):
        if self.index.numel() >= 2**31 or self.n >= INT32_MAX:
            raise ValueError(f"segment index of {self.index.numel()} rows into {self.n} segments exceeds int32")
        sorted_index, order = torch.sort(self.index, stable=True)
        bounds = torch.arange(self.n + 1, dtype=sorted_index.dtype, device=sorted_index.device)
        self._order = order.to(torch.int32)
        self._offsets = torch.searchsorted(sorted_index, bounds, out_int32=True)
        # the kernel reads a long segment's start from offsets[by_length[i]]
        self._sorted_lengths, self._by_length = torch.sort(self._offsets[1:] - self._offsets[:-1], descending=True,
                                                           stable=True)

    def _built(self, name):
        if self._order is None:
            self._build()
        return getattr(self, name)

    @property
    def order(self) -> torch.Tensor:
        return self._built("_order")

    @property
    def offsets(self) -> torch.Tensor:
        return self._built("_offsets")

    @property
    def by_length(self) -> torch.Tensor:
        return self._built("_by_length")

    @property
    def sorted_lengths(self) -> torch.Tensor:
        return self._built("_sorted_lengths")

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


_LAUNCH = {torch.float32: "segment_sum_f32_launch", torch.float64: "segment_sum_f64_launch"}
_PREVIOUS = {torch.float32: "segment_sum_previous_f32_launch", torch.float64: "segment_sum_previous_f64_launch"}


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        err = lib.segment_sum_init()
        if err != 0:
            raise RuntimeError(f"segment_sum_init failed: CUDA error {err}")
        got = (ctypes.c_int * 8)()
        got = tuple(got[:lib.segment_sum_constants(got)])
        want = (THREADS, ROWS_PER_THREAD, NSTAGE, NORD, LONG_HEAD, VECTOR_BYTES, MAX_SMEM)
        if got != want:
            raise RuntimeError(f"csrc/segment_sum.cu's geometry {got} is not the wrapper's {want}")
        for name in _LAUNCH.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in _PREVIOUS.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_sms = {}


def _sm_count(dev: torch.device) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _sms[key]


def _alignment(ptr: int) -> int:
    return 16 if ptr % 16 == 0 else 8 if ptr % 8 == 0 else 4


def _prepare(values: torch.Tensor, seg: SegmentIndex):
    """(values as (E, C) contiguous, C, the empty output) after the checks
    both CUDA launches share; values on CUDA."""
    dev = values.device
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
    if C >= 2**30:
        raise ValueError(f"{C} columns exceed the kernel's int32 range")
    out = torch.empty((seg.n,) + tail, dtype=values.dtype, device=dev)
    return values.reshape(values.shape[0], C).contiguous(), C, out


def _check_rows(values, seg):
    if values.shape[0] != seg.index.shape[0]:
        raise ValueError(f"{values.shape[0]} rows of values for a segment index of {seg.index.shape[0]}")


def segment_sum(values: torch.Tensor, seg: SegmentIndex) -> torch.Tensor:
    """values (E, ...) summed over `seg`'s segments -> (n, ...).

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise. A CPU tensor takes `segment_sum_reference`."""
    global launches
    _check_rows(values, seg)
    if values.device.type == "cpu":
        return segment_sum_reference(values, seg)
    v, C, out = _prepare(values, seg)
    if seg.n * C == 0:
        return out
    dev = v.device
    lay = layout(v.shape[0], seg.n, C, v.element_size(), _sm_count(dev), _alignment(v.data_ptr()),
                 out.data_ptr() % 16 == 0)
    fn = getattr(_load(), _LAUNCH[v.dtype])
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), seg.by_length.data_ptr(),
                 seg.sorted_lengths.data_ptr(), out.data_ptr(), seg.n, C, lay.long_min, lay.medium_min, lay.long_blocks,
                 lay.rows_per_chunk, lay.copy_bytes, lay.stage_bytes, lay.outputs_per_thread, lay.smem,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err} ({lay})")
    launches += 1
    return out


def _segment_sum_previous(values: torch.Tensor, seg: SegmentIndex) -> torch.Tensor:
    """`segment_sum` on CUDA tensors by the previous design (one thread
    per (segment, column)), the same bits; for timing the kernel against
    it, not counted in `launches`."""
    _check_rows(values, seg)
    v, C, out = _prepare(values, seg)
    if seg.n * C == 0:
        return out
    dev = v.device
    fn = getattr(_load(), _PREVIOUS[v.dtype])
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), out.data_ptr(), seg.n, C,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"previous segment_sum kernel launch failed: CUDA error {err}")
    return out
