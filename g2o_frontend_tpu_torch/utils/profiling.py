"""Tracing and device timing (counterpart of
``g2o_frontend_tpu/utils/profiling.py``).

- `device_time`: seconds per call of ``f(*inputs)`` as the slope between
  the least of a few n-call runs and the least of a few n//4-call runs, so
  that what every run pays once cancels and a disturbed run drops out. On
  CUDA inputs each run is one CUDA graph replay timed by CUDA events: the
  JAX version's on-device ``fori_loop``, which keeps host dispatch out of
  the time; a graph replays every captured launch, so nothing is hoisted
  or dropped. On CPU inputs the runs are timed by the host clock (the
  caller asked for the CPU, as JAX's CPU backend would be). `graph_ms`
  is the same in milliseconds per call of a function of no arguments;
  `in_turns` times two versions of a kernel that way in turns.
- `span`: a named interval of the program's host time, recorded only while
  a ``torch.profiler`` session records (``torch.autograd.profiler.
  _is_profiler_enabled``, which torch sets for a session of any
  activities); outside one a call costs that flag check and returns a
  shared no-op. A span keeps its name, its start and end in ns on the
  profiler's own host clock (``CLOCK_REALTIME``, `time.time_ns`, on which
  kineto's events and `Span`s compare directly), the id of the span open
  around it on its thread, and a request id (a frame, a scan call, a
  solve) that its children inherit. Spans go to a buffer of at most
  `SPAN_CAPACITY`; `spans` returns them, `clear_spans` empties it;
  `recording` says whether a session records.
- `trace`: ``torch.profiler`` around a block (CUDA activity where there is
  a card, CPU activity where there is none: the CPU activity doubles a
  live frame on the card), writing a Chrome trace into a directory (the
  JAX version's ``jax.profiler`` trace directory) with the block's spans
  as a host track on the trace's time base.
- `event_ms`, `device_ms`: CUDA-only timers of `chip_smoke.py` for whole
  calls of the captured stages (``utils/graphs``: a `graph_ms` capture
  would run their eager bodies inline, not their own graphs): CUDA events
  per run, and the kernel time that ``torch.profiler`` records;
  `gpu_name_and_power_limit`, the line that goes beside every number.
- `bound`: the least time of a kernel at one H100's peaks (`HBM_BYTES_PER_S`,
  `F32_OPS_PER_S`; `L2_BYTES` says how much a timing loop must stream to
  read from device memory and not from L2); `CheckFailure`, what the smoke
  run and the probe app raise when a check fails.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

__all__ = [
    "device_time", "graph_ms", "in_turns", "span", "spans", "clear_spans", "recording", "Span", "SPAN_CAPACITY",
    "trace", "gpu_name_and_power_limit", "event_ms", "device_ms", "bound", "CheckFailure", "HBM_BYTES_PER_S",
    "F32_OPS_PER_S", "L2_BYTES",
]

# One H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32 operations/s
# outside the tensor cores, and the L2 cache.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2**20


class CheckFailure(Exception):
    """A result that disagrees with its reference, or a count that is off."""


def bound(n_bytes, n_ops=0):
    """(bound_ms, bound_by): the least time for `n_bytes` of device memory
    traffic and `n_ops` float32 operations at the card's peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _cuda_runs(f, inputs, counts):
    """One CUDA graph for each count in `counts`, capturing that many calls
    of ``f(*inputs)``, after one warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for k in counts:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(k):
                f(*inputs)
        graphs.append(g)

    def replay(g):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 1e3

    return [lambda g=g: replay(g) for g in graphs]


def _host_runs(f, inputs, counts):
    f(*inputs)

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            f(*inputs)
        return time.perf_counter() - t0

    return [lambda k=k: run(k) for k in counts]


def device_time(f, inputs, n: int = 20, reps: int = 3) -> float:
    """Seconds per call of ``f(*inputs)``: the slope between the least of
    `reps` n-call runs and the least of `reps` n//4-call runs, taken in
    turns. (The least of `reps` slopes would pick the run whose short
    side was disturbed, down to a negative time.) The device is that of
    the first tensor in `inputs`. On CUDA, `f` must be capturable in a
    CUDA graph (no host synchronisation)."""
    n_small = max(n // 4, 1)
    dev = next((x.device for x in inputs if isinstance(x, torch.Tensor)), torch.device("cpu"))
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            small, big = _cuda_runs(f, inputs, (n_small, n))
    elif dev.type == "cpu":
        small, big = _host_runs(f, inputs, (n_small, n))
    else:
        raise ValueError(f"device_time runs on CPU or CUDA tensors, got {dev}")
    t_small, t_big = float("inf"), float("inf")
    for _ in range(reps):
        t_small = min(t_small, small())
        t_big = min(t_big, big())
    return (t_big - t_small) / (n - n_small)


def graph_ms(fn, like, n: int = 20) -> float:
    """Milliseconds per call of ``fn()`` by `device_time` on the device of
    the tensor `like`: on the card, the slope of CUDA graph replays."""
    return device_time(lambda _: fn(), [like], n=n) * 1e3


def in_turns(new, old, like, n: int = 20):
    """(new ms, old ms): `graph_ms` of two versions of a computation in
    turns, old, new, new, old, each the lesser of its two, so that a
    drift of the card's clock during the four runs falls on both."""
    o1, n1, n2, o2 = graph_ms(old, like, n), graph_ms(new, like, n), graph_ms(new, like, n), graph_ms(old, like, n)
    return min(n1, n2), min(o1, o2)


# -- spans ------------------------------------------------------------------------------

SPAN_CAPACITY = 1 << 20


class Span(NamedTuple):
    """One recorded span. `id` numbers spans in the order they opened;
    `parent` is the `id` of the span open around it on its thread (-1 at
    the top); `request` is its own request id or its parent's (None where
    no span up its stack gave one). Times are ns on the profiler's host
    clock."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: object


_SPANS: deque = deque(maxlen=SPAN_CAPACITY)
_IDS = itertools.count()
_OPEN = threading.local()


class _Off:
    """What `span` returns outside a profiler session: enters and exits."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, exc, tb):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "request", "id", "parent", "start", "stack")

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.request is None:
                self.request = top.request
        else:
            self.parent = -1
        self.id = next(_IDS)
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, typ, exc, tb):
        end = time.time_ns()
        self.stack.pop()
        _SPANS.append(Span(self.id, self.name, self.start, end, self.parent, self.request))
        return False


def span(name: str, request=None):
    """``with span("launch"):`` records the block as a `Span` while a
    ``torch.profiler`` session records; otherwise a shared no-op. `name`
    should be a string made once (a constant, or one stored on its
    object), so that the call allocates nothing when off."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, request)


def recording() -> bool:
    """Whether a ``torch.profiler`` session records now (spans record)."""
    return _autograd_profiler._is_profiler_enabled


def spans() -> list[Span]:
    """The recorded spans, in the order they closed (the last
    `SPAN_CAPACITY`)."""
    return list(_SPANS)


def clear_spans():
    _SPANS.clear()


def _add_spans(path, recorded):
    """Append `recorded` to the Chrome trace file at `path` as one host
    track, on the file's time base (``ts`` in us from
    ``baseTimeNanoseconds``)."""
    with open(path) as fh:
        doc = json.load(fh)
    base, pid, tid = doc.get("baseTimeNanoseconds", 0), os.getpid(), 0
    events = doc.setdefault("traceEvents", [])
    events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": "program spans"}})
    for s in recorded:
        events.append({"name": s.name, "ph": "X", "cat": "span", "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "request": s.request}})
    with open(path, "w") as fh:
        json.dump(doc, fh)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/tb'):`` profile the block into a Chrome trace
    file in `log_dir`: the card's kernels, copies and runtime calls where
    there is a card, the host's operations where there is none, and the
    block's spans as the track "program spans" over them."""
    cuda = torch.cuda.is_available()
    log_dir = str(log_dir)
    os.makedirs(log_dir, exist_ok=True)
    opened = time.time_ns()

    def write(prof):
        path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        _add_spans(path, [s for s in _SPANS if s.start_ns >= opened])

    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU], on_trace_ready=write) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def gpu_name_and_power_limit():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, runs):
    """Per-run milliseconds of `fn` by CUDA events, one pair per run."""
    fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return times


def device_ms(fn, n):
    """Device milliseconds per call of `fn`: the CUDA kernel time that
    torch.profiler records over n calls, divided by n."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.key_averages() if str(e.device_type).endswith("CUDA"))
    if not total_us > 0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / 1000.0 / n
