"""Captured stages: the port's counterpart of ``jax.jit`` with
``static_argnames`` on the PWN main path.

The JAX package compiles `depth_to_cloud`, `align`, `align_batch` and the
`odometry_scan` step each into one device program. On a CUDA device the
port captures each of them once per key into a ``torch.cuda.CUDAGraph``
and replays it on every later call, so that a call costs one graph launch
instead of one host dispatch for each of its ~300-2,000 operations.

- The key (`key`): the stage; its static arguments, compared by value
  (projectors and configs are frozen dataclasses, so they hash); the
  shape, dtype, strides and device of every tensor argument; and the
  structure of the arguments (a ``None`` where an optional tensor may
  stand, the fields of a ``NamedTuple``, the length of a tuple). The
  public functions turn host values (a numpy `initial_guess`) into device
  tensors before they reach the stage, so a numpy and a tensor argument
  give the same key.
- The first call with a key runs the eager body once on a side stream
  (the warm-up: it builds and loads the ctypes kernels, ``ops/cuda_build``,
  and creates the cuBLAS / cuSOLVER handles outside any capture), then
  captures the body into a graph that reads static input buffers. A
  capture that fails raises `CaptureError`, naming the stage and the line
  of the package where it failed; nothing falls back to eager.
- Every call copies its tensors into the static inputs, replays, and
  returns clones of the static outputs: fresh tensors, as the JAX
  function's outputs are fresh arrays. A caller may keep them across
  later calls (the tracker keeps a keyframe's cloud).
- The kernel wrappers count launches when they run, which under a graph
  is only during the capture. The warm-up's and the capture's counts are
  taken back, and every replay adds the launches its capture made
  (`COUNTERS`), so the counts are those of an eager run.
- A call whose tensors lie on the CPU runs the eager body: the caller
  asked for the CPU. A call made while the current stream is already
  capturing runs the eager body inline, so that it becomes part of the
  enclosing graph (``utils/profiling.device_time`` captures what it
  times).
- All graphs of a device share one memory pool
  (``torch.cuda.graph_pool_handle``). That is safe for the order in which
  they replay, whatever it is: a graph's static inputs live outside the
  pool, its outputs are cloned on the caller's stream right after its
  replay and before any other graph replays, and its scratch is dead
  between replays, so another graph may reuse any of that memory. Graphs
  replay on the caller's current stream; two stages must not replay on
  two streams at once.
- `Stage.scan` runs a step ``(carry, x) -> (carry, out)`` over the leading
  axis of `xs` (the JAX ``lax.scan``): one capture, one replay a step; the
  carry stays in the graph's static buffers between steps (the step's last
  captured operations copy the new carry into them), so nothing is copied
  a step but `x` and the outputs.

`captures` lists every key captured so far with its capture time and the
bytes its capture added to the pool.
"""
from __future__ import annotations

import os
import time
import traceback
from dataclasses import dataclass

import torch

from ..ops import fused_aligner, linearizer

# the launch counters of the kernels the stages run: (module, attribute)
COUNTERS = (
    (fused_aligner, "launches"),
    (fused_aligner, "batch_launches"),
    (linearizer, "launches"),
)

_HERE = os.path.abspath(__file__)
_TORCH = os.path.dirname(torch.__file__)


class CaptureError(RuntimeError):
    """A stage's body could not be captured into a CUDA graph."""


# -- arguments: a tree of tuples, NamedTuples and lists over tensors and statics


def _describe(x, leaves):
    """The hashable structure of `x`; its tensors are appended to `leaves`
    in order. A tensor stands as its shape, dtype, strides and device."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype, x.stride(), x.device)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_describe(v, leaves) for v in x))
    hash(x)  # a static argument must hash, as jax.jit's static_argnames must
    return ("static", type(x), x)


def _build(desc, tensors):
    """The tree that `desc` describes, its tensors taken from the iterator
    `tensors`."""
    if desc[0] == "tensor":
        return next(tensors)
    if desc[0] == "static":
        return desc[2]
    typ, children = desc
    values = [_build(c, tensors) for c in children]
    return typ(*values) if hasattr(typ, "_fields") else typ(values)


def key(*args):
    """(the arguments' structure, their tensors): the structure is the cache
    key of a stage called with `args`."""
    leaves = []
    return _describe(args, leaves), leaves


def _device(name, tensors):
    """The one device of `tensors`, or the CPU when there are none."""
    devices = {x.device for x in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensor arguments on several devices {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cpu")


def _counts():
    return [getattr(mod, attr) for mod, attr in COUNTERS]


def _set_counts(values):
    for (mod, attr), v in zip(COUNTERS, values):
        setattr(mod, attr, v)


def _where(exc):
    """The first error of a failed capture (a failed operation also fails
    the capture's end), and 'file:line in function: code' of the innermost
    frame of its traceback outside torch and this module: the operation
    the capture failed at."""
    while exc.__context__ is not None:
        exc = exc.__context__
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if not f.filename.startswith(_TORCH) and os.path.abspath(f.filename) != _HERE]
    f = frames[-1] if frames else None
    at = f"{f.filename}:{f.lineno} in {f.name}: {f.line}" if f else "an unknown line"
    return f"{at}: {type(exc).__name__}: {exc}"


_POOLS: dict = {}


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def _pool_bytes(device):
    """Bytes of the device's graph pool, from the allocator's snapshot."""
    pool = tuple(_POOLS[device])
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool and s.get("device", device.index) == device.index)


@dataclass
class Capture:
    """One captured key: what `captures` reports of it."""

    stage: str
    shapes: tuple  # the shapes of its tensor arguments
    capture_ms: float  # warm-up, capture and the allocator's bookkeeping, host clock
    pool_bytes: int  # bytes its capture added to the shared pool
    input_bytes: int  # its static input buffers (outside the pool)
    launches: dict  # kernel launches a replay counts, by counter


_CAPTURES: list[Capture] = []


def captures():
    """Every key captured in this process, in capture order."""
    return list(_CAPTURES)


class Graph:
    """A captured body: static inputs, the graph, static outputs."""

    def __init__(self, graph, static_in, static_out, out_desc, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.out_desc = out_desc
        self.launches = launches  # per counter of COUNTERS, the launches one replay makes

    def replay(self, tensors, first=0):
        """Copy `tensors` into the static inputs from the `first` on, replay,
        count the captured launches, and return clones of the outputs."""
        for s, x in zip(self.static_in[first:], tensors):
            s.copy_(x)
        self.graph.replay()
        _set_counts([c + n for c, n in zip(_counts(), self.launches)])
        return _build(self.out_desc, iter([o.clone() for o in self.static_out]))


class Stage:
    """One body, captured once per key on a CUDA device (see the module
    docstring). ``stage(*args)`` is ``body(*args)``."""

    def __init__(self, name, body):
        self.name = name
        self.body = body
        self._graphs: dict = {}

    def __call__(self, *args):
        desc, tensors = key(*args)
        device = _device(self.name, tensors)
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return self.body(*args)
        graph = self._graphs.get(desc)
        if graph is None:
            graph = self._graphs[desc] = self._capture(desc, tensors, device)
        return graph.replay(tensors)

    def _capture(self, desc, tensors, device, scan=None):
        """Warm up and capture `body` on static copies of `tensors`. With
        `scan`, the number of carry tensors, the body is a scan step: its new
        carry is copied into the carry's static buffers as the graph's last
        operations, and only its outputs are returned."""
        t0 = time.perf_counter()
        static_in = [x.clone() for x in tensors]
        args = _build(desc, iter(static_in))
        before = _counts()
        with torch.cuda.device(device):
            pool_before = _pool_bytes(device) if device in _POOLS else 0
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.body(*args)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=_pool(device)):
                    start = _counts()
                    out = self.body(*args)
                    if scan is not None:
                        carry, out = out
                        carry_now = key(carry)[1]
                        for s, x in zip(static_in[: scan], carry_now):
                            s.copy_(x)
                    launches = [b - a for a, b in zip(start, _counts())]
            except Exception as exc:
                # the failed capture leaves its pool recording: later captures take a new one
                _POOLS.pop(device, None)
                raise CaptureError(f"CUDA graph capture of {self.name} failed at {_where(exc)}") from exc
            finally:
                _set_counts(before)
            torch.cuda.synchronize()
            out_desc, static_out = key(out)
            out_desc = out_desc[1][0]  # key() wraps its arguments in a tuple
            _CAPTURES.append(Capture(
                stage=self.name, shapes=tuple(tuple(x.shape) for x in tensors),
                capture_ms=(time.perf_counter() - t0) * 1e3, pool_bytes=_pool_bytes(device) - pool_before,
                input_bytes=sum(x.numel() * x.element_size() for x in static_in),
                launches={f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": n
                          for (mod, attr), n in zip(COUNTERS, launches) if n}))
        return Graph(graph, static_in, static_out, out_desc, launches)

    def scan(self, carry, xs, *consts):
        """``lax.scan`` of the body ``(carry, x, *consts) -> (carry, out)``
        over the leading axis of the tensor `xs`: (the last carry, [out of
        each step]). On a CUDA device one graph (per key of the carry, one
        x and `consts`) replays once a step; on the CPU, or inside an
        enclosing capture, the body runs eagerly (`iterate`)."""
        if len(xs) == 0:
            return carry, []
        desc, tensors = key(carry, xs[0], *consts)
        desc = ("scan", desc)  # a scan's graph returns the step's outputs only
        device = _device(self.name, tensors + [xs])
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return iterate(self.body, carry, xs, *consts)
        n_carry = len(key(carry)[1])
        graph = self._graphs.get(desc)
        if graph is None:
            graph = self._graphs[desc] = self._capture(desc[1], tensors, device, scan=n_carry)
        for s, x in zip(graph.static_in, tensors):  # the carry, the first x and the constants
            s.copy_(x)
        outs = [graph.replay([x], first=n_carry) for x in xs]
        carry_desc = key(carry)[0][1][0]  # key() wraps its arguments in a tuple
        return _build(carry_desc, iter([s.clone() for s in graph.static_in[:n_carry]])), outs


def iterate(step, carry, xs, *consts):
    """The eager scan: (the last carry, [out of each step])."""
    outs = []
    for x in xs:
        carry, out = step(carry, x, *consts)
        outs.append(out)
    return carry, outs

