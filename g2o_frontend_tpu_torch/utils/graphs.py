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

Loops and solves, the counterpart of ``lax.while_loop`` in the 2D and 3D
backend's solvers (``solvers/pcg``, ``pose_graph``, ``schur_pcg``):

- A `Loop` is ``while cond(consts, carry): carry = body(consts, carry)``
  with the condition a device tensor. It runs in blocks of `block` masked
  steps, ``carry = where(cond(carry), body(carry), carry)``; a step after
  the stop changes no bit, so blocks of any size end on the eager loop's
  carry, step for step. One host read of the condition a block.
- A `Solve` is an outer loop of a fixed bound over a head, an inner
  `Loop` and a tail (an LM iteration: linearize and start CG; CG; step,
  accept, lambda). `solve_loop` runs it: on the card, a key seen before
  (captured at its second call) is a `_Chain` of graphs (head, block,
  tail) that read each other's outputs and the static buffers of the
  inputs, the state and the inner carry directly; a key seen once runs its
  head and tail eagerly and its blocks through `_Blocks`, whose graph is
  captured at the loop's second block and dropped when the solve ends, so
  that shapes seen once hold no memory. Host reads: one a block, and one
  report (1-dim int64) an outer iteration for a solve that stops on
  convergence, else one at the end. Nothing falls back: a capture that
  fails raises `CaptureError`.
- `mode` runs them otherwise: "masked" (the same masked blocks eagerly,
  the CPU's way) or "eager" (a host read before every step, no masking:
  the eager port, against which the graphs are held bit for bit).
- Trees of arguments may hold objects with ``__tree_flatten__`` /
  ``__tree_unflatten__`` (the pose graphs, ``ops/segment_sum.SegmentIndex``).
- The pool is kept alive by a one-operation anchor graph, since dropped
  block graphs may be the last to have captured into it.

`captures` lists every key and solve piece captured so far with its
capture time and the bytes its capture added to the pool; `host_reads`
counts the reads of loops and solves.

Spans (``utils/profiling.span``, recorded while a profiler session
records): ``stage:<name>`` around a stage's call on every path and around
each step of its scan (copy-in, launch, clone-out); ``launch`` around each
``CUDAGraph.replay()`` alone; ``capture:<name>`` around each capture;
``host_read`` around each read that `host_reads` counts. `replay_ns` and
`replays` time the replays always, until a profiler records one.
"""
from __future__ import annotations

import os
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..ops import fused_aligner, linearizer, segment_sum
from .profiling import recording, span

# the launch counters of the kernels the stages and loops run: (module, attribute)
COUNTERS = (
    (fused_aligner, "launches"),
    (fused_aligner, "batch_launches"),
    (linearizer, "launches"),
    (segment_sum, "launches"),
    (fused_aligner, "step_launches"),
)

MODES = ("graph", "masked", "eager")
_MODE = ["graph"]

# host reads made by loops and solves since the last reset: a loop's
# condition, a solve's report
host_reads = 0


def _flag(t):
    global host_reads
    host_reads += 1
    with span("host_read"):
        return bool(t)


def _report(t):
    global host_reads
    host_reads += 1
    with span("host_read"):
        return t.tolist()


# the host's ns in ``CUDAGraph.replay()`` and the replays timed: every
# replay but a graph's first (which uploads it), until the first replay under
# a profiler (from then on the profiler's cost lands in each replay, also
# after its session: 5-8x the host time on an H100)
replay_ns = 0
replays = 0
_profiled = False


def _launch(graph, first):
    """``graph.replay()`` in a ``launch`` span, its host time counted
    unless `first` or a profiler has recorded a replay."""
    global replay_ns, replays, _profiled
    with span("launch"):
        t = time.perf_counter_ns()
        graph.replay()
        t = time.perf_counter_ns() - t
    if recording():
        _profiled = True
    elif not first and not _profiled:
        replay_ns += t
        replays += 1


@contextmanager
def mode(name):
    """Within the block, run stages and loops on a CUDA device as `name`
    says: "graph" (the default: captured and replayed), "masked" (a loop's
    masked steps in blocks, eagerly, one host read a block) or "eager"
    (every body eagerly; a loop reads its condition on the host before
    each step and runs no masked step: the eager port)."""
    if name not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {name!r}")
    before = _MODE[0]
    _MODE[0] = name
    try:
        yield
    finally:
        _MODE[0] = before

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
    if hasattr(type(x), "__tree_flatten__"):
        aux, children = x.__tree_flatten__()
        return ("node", type(x), aux, tuple(_describe(v, leaves) for v in children))
    hash(x)  # a static argument must hash, as jax.jit's static_argnames must
    return ("static", type(x), x)


def _build(desc, tensors):
    """The tree that `desc` describes, its tensors taken from the iterator
    `tensors`."""
    if desc[0] == "tensor":
        return next(tensors)
    if desc[0] == "static":
        return desc[2]
    if desc[0] == "node":
        return desc[1].__tree_unflatten__(desc[2], [_build(c, tensors) for c in desc[3]])
    typ, children = desc
    values = [_build(c, tensors) for c in children]
    return typ(*values) if hasattr(typ, "_fields") else typ(values)


def flatten(tree):
    """(the structure of `tree`, its tensors in order)."""
    leaves = []
    return _describe(tree, leaves), leaves


def key(*args):
    """(the arguments' structure, their tensors): the structure is the cache
    key of a stage called with `args`."""
    return flatten(args)


def unflatten(desc, leaves):
    """The tree of structure `desc` over the tensors `leaves`."""
    return _build(desc, iter(leaves))


def tree_where(on, new, old):
    """``torch.where(on, a, b)`` over the tensors of two trees of one
    structure: `new` where the 0-dim bool tensor `on` holds, else `old`."""
    desc, a = flatten(new)
    b = flatten(old)[1]
    if len(a) != len(b):
        raise ValueError(f"trees of {len(a)} and {len(b)} tensors")
    return unflatten(desc, [torch.where(on, x, y) for x, y in zip(a, b)])


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
_ANCHORS: list = []


def _pool(device):
    """The device's shared graph pool. A pool lives while some graph that
    captured into it does, and a loop's block graphs are dropped when their
    solve ends: a one-operation graph captured first keeps the pool."""
    if device not in _POOLS:
        pool = torch.cuda.graph_pool_handle()
        anchor, side = torch.cuda.CUDAGraph(), _side(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            anchor.capture_begin(pool=pool)
            torch.zeros(1, device=device).add_(1.0)
            anchor.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        _ANCHORS.append(anchor)
        _POOLS[device] = pool
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
    kept: bool = True  # False: a loop's block graph, dropped when its solve ends


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
        self.replayed = False

    def replay(self, tensors, first=0):
        """Copy `tensors` into the static inputs from the `first` on, replay,
        count the captured launches, and return clones of the outputs."""
        for s, x in zip(self.static_in[first:], tensors):
            s.copy_(x)
        _launch(self.graph, not self.replayed)
        self.replayed = True
        _set_counts([c + n for c, n in zip(_counts(), self.launches)])
        return _build(self.out_desc, iter([o.clone() for o in self.static_out]))


class Stage:
    """One body, captured once per key on a CUDA device (see the module
    docstring). ``stage(*args)`` is ``body(*args)``."""

    def __init__(self, name, body, second_call=False):
        self.name = name
        self.body = body
        self.second_call = second_call  # capture a key at its second call, not its first
        self._span, self._capture_span = "stage:" + name, "capture:" + name
        self._graphs: dict = {}
        self._seen: set = set()

    def __call__(self, *args):
        with span(self._span):
            desc, tensors = key(*args)
            device = _device(self.name, tensors)
            if device.type != "cuda" or torch.cuda.is_current_stream_capturing() or _MODE[0] != "graph":
                return self.body(*args)
            graph = self._graphs.get(desc)
            if graph is None:
                if self.second_call and desc not in self._seen:
                    self._seen.add(desc)
                    return self.body(*args)
                graph = self._graphs[desc] = self._capture(desc, tensors, device)
            return graph.replay(tensors)

    def _step(self, *args):
        """The body as one step of an eager scan, in its stage's span."""
        with span(self._span):
            return self.body(*args)

    def _capture(self, desc, tensors, device, scan=None):
        """Warm up and capture `body` on static copies of `tensors`. With
        `scan`, the number of carry tensors, the body is a scan step: its new
        carry is copied into the carry's static buffers as the graph's last
        operations, and only its outputs are returned."""
        with span(self._capture_span):
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
        if device.type != "cuda" or torch.cuda.is_current_stream_capturing() or _MODE[0] != "graph":
            return iterate(self._step, carry, xs, *consts)
        n_carry = len(key(carry)[1])
        graph = self._graphs.get(desc)
        if graph is None:
            graph = self._graphs[desc] = self._capture(desc[1], tensors, device, scan=n_carry)
        for s, x in zip(graph.static_in, tensors):  # the carry, the first x and the constants
            s.copy_(x)
        outs = []
        for x in xs:
            with span(self._span):
                outs.append(graph.replay([x], first=n_carry))
        carry_desc = key(carry)[0][1][0]  # key() wraps its arguments in a tuple
        return _build(carry_desc, iter([s.clone() for s in graph.static_in[:n_carry]])), outs


def iterate(step, carry, xs, *consts):
    """The eager scan: (the last carry, [out of each step])."""
    outs = []
    for x in xs:
        carry, out = step(carry, x, *consts)
        outs.append(out)
    return carry, outs



# -- loops: the counterpart of lax.while_loop ------------------------------------------


class Loop(NamedTuple):
    """``while cond(consts, carry): carry = body(consts, carry)``, at most
    `max_steps` steps, run in blocks of `block` masked steps (`masked_block`).
    `cond` returns a 0-dim bool tensor; the carry is a tree of tensors."""

    cond: Callable
    body: Callable
    max_steps: int
    block: int


def masked_block(loop: Loop, consts, carry):
    """`loop.block` masked steps: ``carry = where(cond(carry), body(carry),
    carry)``. A step after the condition fails changes no bit of the carry,
    so blocks of any size end on the eager loop's carry, step for step."""
    for _ in range(loop.block):
        carry = tree_where(loop.cond(consts, carry), loop.body(consts, carry), carry)
    return carry


def _eager_loop(loop, consts, carry):
    """The eager loop: the condition read on the host before each step."""
    while _flag(loop.cond(consts, carry)):
        carry = loop.body(consts, carry)
    return carry


def _masked_loop(loop, consts, carry, capturing=False):
    """Masked blocks, one host read of the condition after each; inside an
    enclosing capture (`capturing`), which cannot read, every block that
    `max_steps` allows."""
    if capturing:
        for _ in range(-(-loop.max_steps // loop.block)):
            carry = masked_block(loop, consts, carry)
        return carry
    while True:
        carry = masked_block(loop, consts, carry)
        if not _flag(loop.cond(consts, carry)):
            return carry


_SIDE: dict = {}


def _side(device):
    """The device's stream for warm-ups and captures."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def _write(buffers, tree):
    """Copy the tensors of `tree` into `buffers` (a list), skipping a tensor
    that is its buffer."""
    for b, x in zip(buffers, flatten(tree)[1]):
        if x is not b:
            b.copy_(x)


class _Piece:
    """One captured graph of a loop or a solve; its outputs stay where the
    capture left them (the next graph reads them) and are kept alive, so
    that no later capture takes their memory from the shared pool."""

    def __init__(self, graph, out, launches):
        self.graph, self.out, self.launches = graph, out, launches
        self.replayed = False

    def replay(self):
        _launch(self.graph, not self.replayed)
        self.replayed = True
        _set_counts([c + n for c, n in zip(_counts(), self.launches)])


def _capture_piece(name, fn, device, reads, kept=True):
    """Capture ``fn()`` on the device's side stream into its shared pool
    (`fn` closes over static tensors; its warm-up ran before). Returns the
    `_Piece`; its launches are taken back from the counters. `reads` is
    the static tensors it reads, for the capture record."""
    with span("capture:" + name):
        t0 = time.perf_counter()
        before = _counts()
        pool = _pool(device)
        pool_before = _pool_bytes(device) if kept else 0
        side = _side(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                out = fn()
                launches = [b - a for a, b in zip(before, _counts())]
            except Exception as exc:
                try:
                    graph.capture_end()
                except Exception:  # the capture is invalid already: the first error is the one to name
                    pass
                _POOLS.pop(device, None)
                raise CaptureError(f"CUDA graph capture of {name} failed at {_where(exc)}") from exc
            finally:
                _set_counts(before)
            try:
                graph.capture_end()
            except Exception as exc:
                _POOLS.pop(device, None)
                raise CaptureError(f"CUDA graph capture of {name} failed at {_where(exc)}") from exc
        torch.cuda.current_stream(device).wait_stream(side)
        _CAPTURES.append(Capture(
            stage=name, shapes=tuple(tuple(x.shape) for x in reads), capture_ms=(time.perf_counter() - t0) * 1e3,
            pool_bytes=_pool_bytes(device) - pool_before if kept else -1,
            input_bytes=sum(x.numel() * x.element_size() for x in reads),
            launches={f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}": n for (mod, attr), n in zip(COUNTERS, launches) if n},
            kept=kept))
        return _Piece(graph, out, launches)


def _warm(device, fn):
    """``fn()`` on the side stream, before a capture: it builds the kernels
    and creates the library handles and workspaces that the capture then
    finds. Its launches are taken back."""
    before = _counts()
    side = _side(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    _set_counts(before)
    return out


class _Sources:
    """Static tensors loaded from the caller's tensors; a tensor loaded
    before and not modified since (the same object at the same version) is
    not copied again."""

    def __init__(self, leaves):
        self.static = [x.clone() for x in leaves]
        self._src = [(x, x._version) for x in leaves]

    def load(self, leaves):
        for i, (s, x) in enumerate(zip(self.static, leaves)):
            src, version = self._src[i]
            if x is s or (x is src and x._version == version):
                continue
            s.copy_(x)
            self._src[i] = (x, x._version)


class _Blocks:
    """The blocks of a loop whose constants come from eager code, for one
    solve: its first block runs eagerly, its second captures a graph that
    every later block replays, constants and carry in static buffers
    between replays. The graph goes with this object."""

    def __init__(self, name, loop, device):
        self.name, self.loop, self.device = name, loop, device
        self.calls = 0
        self.piece = self.consts = self.carry = self.desc = None

    def _capture(self, consts, carry):
        c_desc, c_leaves = flatten(consts)
        self.desc, k_leaves = flatten(carry)
        self.consts = _Sources(c_leaves)
        self.carry = [x.clone() for x in k_leaves]
        static_consts = unflatten(c_desc, self.consts.static)
        loop = self.loop

        def warm():
            c = unflatten(self.desc, [x.clone() for x in self.carry])
            return tree_where(loop.cond(static_consts, c), loop.body(static_consts, c), c)

        def block():
            new = masked_block(loop, static_consts, unflatten(self.desc, self.carry))
            flag = loop.cond(static_consts, new)
            _write(self.carry, new)
            return flag

        _warm(self.device, warm)
        self.piece = _capture_piece(f"{self.name}: loop block of {loop.block}", block, self.device,
                                    self.consts.static + self.carry, kept=False)

    def run(self, consts, carry):
        """The loop from `carry` to its end: the last carry, fresh tensors."""
        loaded = False
        while True:
            if self.piece is None and self.calls >= 1:
                self._capture(consts, carry)
                loaded = True
            if self.piece is None:
                carry = masked_block(self.loop, consts, carry)
                self.calls += 1
                if not _flag(self.loop.cond(consts, carry)):
                    return carry
                continue
            if not loaded:
                self.consts.load(flatten(consts)[1])
                _write(self.carry, carry)
                loaded = True
            self.piece.replay()
            self.calls += 1
            if not _flag(self.piece.out):
                return unflatten(self.desc, [x.clone() for x in self.carry])


def while_loop(name, loop: Loop, consts, carry):
    """``lax.while_loop`` over `loop`: the last carry. On a CUDA device the
    first block runs eagerly and the second captures a graph that the rest
    replay (dropped when the loop ends); one host read of the condition a
    block. On the CPU, inside an enclosing capture, or in "masked" mode,
    the same masked blocks run eagerly; in "eager" mode, the plain loop."""
    device = _device(name, flatten((consts, carry))[1])
    if _MODE[0] == "eager":
        return _eager_loop(loop, consts, carry)
    if device.type != "cuda" or _MODE[0] == "masked":
        return _masked_loop(loop, consts, carry)
    if torch.cuda.is_current_stream_capturing():
        return _masked_loop(loop, consts, carry, capturing=True)
    return _Blocks(name, loop, device).run(consts, carry)


# -- solves: a head, an inner loop, a tail, an outer loop of fixed bound ------------------


class Solve(NamedTuple):
    """An iterative solve in pieces, each a function of trees of tensors:
    ``head(inputs, state) -> (mid, carry)`` (carry None without `loop`),
    the inner `loop` over ``consts = (inputs, mid)``, ``tail(inputs, state,
    mid, carry) -> state``, and ``report(state)``, a 1-dim int64 tensor read
    on the host: after every outer iteration where `stops` (its first entry
    ends the solve when nonzero), else once at the end."""

    head: Callable
    tail: Callable
    report: Callable
    loop: Loop | None = None
    stops: bool = False


def _solve_eager(solve, inputs, state, iters, inner):
    report = None
    for _ in range(iters):
        mid, carry = solve.head(inputs, state)
        if solve.loop is not None:
            carry = inner(solve.loop, (inputs, mid), carry)
        state = solve.tail(inputs, state, mid, carry)
        if solve.stops:
            report = _report(solve.report(state))
            if report[0]:
                return state, report
    return state, _report(solve.report(state)) if report is None or not solve.stops else report


class _Chain:
    """A solve captured as graphs for one key: the head, the inner loop's
    block and the tail, each reading the static buffers and outputs of the
    ones before it directly. Inputs and state live in static buffers, the
    inner carry too; the head writes the carry's start, the block updates
    the carry and leaves its condition, the tail writes the new state and
    its report."""

    def __init__(self, name, solve, inputs, state, device):
        self.solve = solve
        in_desc, in_leaves = flatten(inputs)
        self.st_desc, st_leaves = flatten(state)
        self.inputs = _Sources(in_leaves)
        self.state = [x.clone() for x in st_leaves]
        I, S = unflatten(in_desc, self.inputs.static), unflatten(self.st_desc, self.state)
        loop = solve.loop

        def warm():  # one outer iteration with one inner step, on the static buffers' values
            mid, carry = solve.head(I, S)
            if loop is not None:
                carry = tree_where(loop.cond((I, mid), carry), loop.body((I, mid), carry), carry)
            return solve.report(solve.tail(I, S, mid, carry)), flatten(carry)

        _, (c_desc, c_leaves) = _warm(device, warm)
        self.carry = [torch.empty_like(x) for x in c_leaves]
        C = unflatten(c_desc, self.carry)
        reads = self.inputs.static + self.state

        def head():
            mid, carry = solve.head(I, S)
            _write(self.carry, carry)
            return mid

        self.head = _capture_piece(f"{name}: head", head, device, reads)
        mid = self.head.out
        self.block = None
        if loop is not None:
            def block():
                new = masked_block(loop, (I, mid), C)
                flag = loop.cond((I, mid), new)
                _write(self.carry, new)
                return flag

            self.block = _capture_piece(f"{name}: loop block of {loop.block}", block, device, self.carry)

        def tail():
            new = solve.tail(I, S, mid, C)
            report = solve.report(new)
            _write(self.state, new)
            return report

        self.tail = _capture_piece(f"{name}: tail", tail, device, [])

    def run(self, inputs, state, iters):
        self.inputs.load(flatten(inputs)[1])
        _write(self.state, state)
        report = None
        for _ in range(iters):
            self.head.replay()
            if self.block is not None:
                self.block.replay()
                while _flag(self.block.out):
                    self.block.replay()
            self.tail.replay()
            if self.solve.stops:
                report = _report(self.tail.out)
                if report[0]:
                    break
        if report is None or not self.solve.stops:
            report = _report(self.tail.out if iters > 0 else self.solve.report(state))
        return unflatten(self.st_desc, [x.clone() for x in self.state]), report


_CHAINS: dict = {}
_SOLVES_SEEN: set = set()


def solve_loop(name, solve: Solve, inputs, state, iters):
    """Run `solve` for at most `iters` outer iterations from `state`:
    (the last state, the last report as a list of ints).

    On a CUDA device a key (the name, the inputs' and state's structure,
    `iters`, the loop's bound and block) seen before runs as a `_Chain` of
    graphs, captured at that second call and kept; a key seen once runs
    the head and tail eagerly and its inner loop through `_Blocks`, whose
    graph goes when the solve ends. Host reads: one a block, and the
    reports. On the CPU, or in "masked" mode, every piece eagerly with the
    masked blocks; in "eager" mode, the plain loops."""
    desc, leaves = flatten((inputs, state))
    device = _device(name, leaves)
    if _MODE[0] == "eager":
        return _solve_eager(solve, inputs, state, iters, _eager_loop)
    if device.type != "cuda" or _MODE[0] == "masked":
        return _solve_eager(solve, inputs, state, iters, _masked_loop)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name} reads its stopping test on the host: it cannot run inside a capture")
    loop = solve.loop
    k = (name, desc, iters, solve.stops) + ((loop.max_steps, loop.block) if loop is not None else ())
    chain = _CHAINS.get(k)
    if chain is None and k in _SOLVES_SEEN:
        with torch.cuda.device(device):
            chain = _CHAINS[k] = _Chain(name, solve, inputs, state, device)
    if chain is None:
        _SOLVES_SEEN.add(k)
        blocks = None if loop is None else _Blocks(name, loop, device)
        return _solve_eager(solve, inputs, state, iters, lambda lp, consts, carry: blocks.run(consts, carry))
    with torch.cuda.device(device):
        return chain.run(inputs, state, iters)
