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
- `trace`: ``torch.profiler`` around a block, writing a Chrome trace into a
  directory (the JAX version's ``jax.profiler`` trace directory).
- `CumulativeTimer`: cumTime/numCalls accumulator (PwnMatcherBase parity).
- `event_ms`, `device_ms`: CUDA-only timers of `chip_smoke.py` for what a
  CUDA graph cannot capture (a whole align, which reads the host): CUDA
  events per run, and the kernel time that ``torch.profiler`` records;
  `gpu_name_and_power_limit`, the line that goes beside every number.
- `bound`: the least time of a kernel at one H100's peaks (`HBM_BYTES_PER_S`,
  `F32_OPS_PER_S`; `L2_BYTES` says how much a timing loop must stream to
  read from device memory and not from L2); `CheckFailure`, what the smoke
  run and the probe app raise when a check fails.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

__all__ = [
    "device_time", "graph_ms", "in_turns", "trace", "CumulativeTimer", "gpu_name_and_power_limit", "event_ms", "device_ms", "bound",
    "CheckFailure", "HBM_BYTES_PER_S", "F32_OPS_PER_S", "L2_BYTES",
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


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/tb'):`` profile the block (CPU, and CUDA where
    there is a card) into a Chrome trace file in `log_dir`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof


class CumulativeTimer:
    """cumTime/numCalls accumulator (``pwn_matcher_base.h:54-55``)."""

    def __init__(self):
        self.cum_time = 0.0
        self.num_calls = 0

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.cum_time += time.perf_counter() - t0
            self.num_calls += 1

    @property
    def mean(self) -> float:
        return self.cum_time / self.num_calls if self.num_calls else 0.0


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
