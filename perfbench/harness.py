"""The benchmark's general machinery: `BENCHMARK.json` and the files it
names, the card's facts, the traced window's reduction, the checks that
decide `correct`, and the result line.

A cell's driver (``drivers/<name>.py``, named by the traffic file) has
four functions, each given the `Run`:

- ``setup(run)`` builds the program's inputs from the seed, warms up every
  shape the traffic uses and returns the driver's state;
- ``window(run, state, seconds)`` drives the program for `seconds` and
  returns a `Window`;
- ``judge(run, state)``, after the window, frees the program's state and
  returns the `Check`s of its outputs against the plain reference;
- ``control(run, state, precision)`` puts the reference, computed in a
  lower precision, in the program's place (`control.py`, the tests).
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "g2o_frontend_tpu")


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench, workload: str):
    """(the workload entry, its configuration entry) of `workload`."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            for c in bench["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"workload {workload!r} names no configuration of BENCHMARK.json")
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def traffic(name: str):
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(workload: str):
    return load_json(HERE / "limits" / f"{workload}.json")


def metrics_of(bench, kind: str, workload: str):
    """The `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def layer_reader(name: str):
    """The `read` function of ``layer_metrics/<name>.py``, or, where there
    is no such file, of the file named by the part of `name` before its
    first dot (one reader for ``device_idle_pct.track``, ``.schur`` and
    ``.dense``)."""
    path = HERE / "layer_metrics" / f"{name}.py"
    if not path.exists():
        name = name.split(".", 1)[0]
        path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.layer_metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None):
    """Loaded modules whose whole top-level name is JAX's, its libraries'
    or the JAX package's (the port's name begins with the latter's)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


@dataclass
class Run:
    """One run of one cell: what the command line and the files say."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    limits: dict
    device: str = "cuda"
    counters: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)
    tracer: "Tracer | None" = None
    readings: dict = field(default_factory=dict)

    def poll(self, elapsed: float):
        """Called by a driver's window after each request."""
        if self.tracer is not None:
            self.tracer.poll(elapsed)

    @property
    def tracing(self) -> bool:
        """Whether the profiler records now."""
        return self.tracer is not None and self.tracer.prof is not None and self.tracer.results is None

    def traced_seconds(self) -> float:
        """Seconds the profiler took from the window: a traced run's window
        runs that much longer, so that its untraced part is as long as an
        untraced run's."""
        return self.tracer.spent if self.tracer is not None else 0.0

    def say(self, *parts):
        print("[perfbench]", *parts, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What the window did: requests attempted and failed, and the
    end-to-end metrics' values by name."""

    attempted: int
    failed: int
    metrics: dict


@dataclass
class Check:
    """One compared number: the cell is correct when every value is at
    most its limit (an exact comparison has the limit 0)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self):
        return self.value == self.value and self.value <= self.limit


def worst(values):
    """The largest of `values`, or NaN if any is NaN."""
    values = [float(v) for v in values]
    return float("nan") if any(v != v for v in values) else max(values)


def summarise(vals: dict):
    """Each list of per-frame or per-solve gaps as its largest (the name)
    and its 90th percentile (``<name>_p90``: a fault on a tenth of the
    frames or more moves it)."""
    out = {}
    for k, v in vals.items():
        out[k] = worst(v) if v else 0.0
        out[f"{k}_p90"] = (float("nan") if any(x != x for x in v) else percentile(v, 90)) if v else 0.0
    return out


def checks_from(run, readings: dict):
    """The checks of the numbers that the cell's limits file names; every
    reading is kept on the run for the control's table."""
    run.readings = dict(readings)
    return [Check(k, float(readings[k]), float(v)) for k, v in run.limits.items()]


# -- the traced window -------------------------------------------------------------------------


@dataclass
class Reading:
    """What the per-layer readers read: the traced window (`Trace`), the
    program's counters over the whole window, the traced window's length
    by the host's clock, and the configuration."""

    trace: "Trace"
    counters: dict
    window_s: float
    config: dict


class Tracer:
    """torch.profiler's CUDA activity (the device's kernels, copies and
    fills, and the runtime's calls) over the first `seconds` of the window.
    The CPU activity is left off: recording the host's operations doubled a
    live frame's time on the card, which would read as idle device time.
    `window_s` is the traced stretch by the host's clock, the closing
    synchronise included; `spent` adds the profiler's own stop."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None
        self.results = None
        self.window_s = 0.0
        self.spent = 0.0
        self._t0 = None

    def start(self):
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def poll(self, elapsed: float):
        """Stop once `elapsed` seconds of the window have passed."""
        if self.results is None and self.prof is not None and elapsed >= self.seconds:
            self.stop()

    def stop(self):
        import time

        import torch

        if self.results is not None or self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.results = self.prof.profiler.kineto_results
        self.spent = time.perf_counter() - self._t0


@dataclass
class Trace:
    """A kineto trace reduced: device activities (name, start ns, end ns)
    sorted by start; launches, one for each runtime call that started
    device work (its name, the device ns of that work, the set of the
    names of the kernels it ran: a replayed CUDA graph is one launch); the
    runtime's calls (name, start ns, end ns) sorted by start; busy seconds."""

    device: list
    launches: list
    runtime: list
    busy_s: float


def reduce_trace(results):
    device, runtime, calls, ids = [], [], {}, []
    for e in results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            t0 = e.start_ns()
            device.append((name, t0, t0 + e.duration_ns()))
            ids.append((e.correlation_id(), e.linked_correlation_id()))
        elif name.startswith("cu"):  # the runtime's launches, graph launches, copies and syncs
            calls[e.correlation_id()] = name
            runtime.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    work: dict = {}
    for (name, t0, t1), (corr, linked) in zip(device, ids):
        w = work.setdefault(corr if corr in calls else linked, [0, set()])
        w[0] += t1 - t0
        w[1].add(name)
    device.sort(key=lambda d: d[1])
    runtime.sort(key=lambda r: r[1])
    launches = [(calls.get(k, "unknown"), ns, frozenset(names)) for k, (ns, names) in work.items()]
    return Trace(device, launches, runtime, busy_ns(device) / 1e9)


def busy_ns(device):
    """Nanoseconds in which at least one device activity ran (their union)."""
    total, end = 0, None
    for _, t0, t1 in device:
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def breakdown(trace: Trace, top=10):
    """The device operations that took most time, and the longest idle
    gaps, each named by the runtime call in flight on the host at the
    gap's start, or "host" where none was (the host was busy elsewhere)."""
    by_op: dict = {}
    for name, t0, t1 in trace.device:
        by_op[name[:120]] = by_op.get(name[:120], 0) + (t1 - t0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for _, t0, t1 in trace.device:
        if end is not None and t0 > end:
            gaps.append((t0 - end, end))
        end = t1 if end is None else max(end, t1)
    gaps.sort(reverse=True)
    starts = [r[1] for r in trace.runtime]
    named = []
    for dur, at in gaps[:top]:
        k = bisect.bisect_right(starts, at) - 1
        named.append([trace.runtime[k][0] if k >= 0 and trace.runtime[k][2] >= at else "host", dur / 1e9])
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": named}


def card_facts():
    """The first card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def percentile(values, q):
    """The q-th percentile by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def env_for_caches():
    """Every build and kernel cache in fixed directories of the checkout."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
