"""StreamProcessor dataflow: chainable processing nodes (boss_map analog);
the port's copy of ``g2o_frontend_tpu/graph/pipeline.py``, whose code it is.
`StreamProcessorGroup` registers in the port's boss registry.

Re-design of the reference's pipeline spine (``boss_map/stream_processor.h:
10-150``): `StreamProcessor` nodes receive objects via `process()` and emit
results through output handlers (enqueue / propagate-to-sink / write);
`StreamProcessorGroup` wires a named set of processors — and, through the
boss registry, whole pipelines instantiate from config files exactly like
the reference's ``conf/*.conf`` object graphs (``pwn_slam_app.cpp:41-59``).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Callable

from ..io import boss


class StreamProcessor:
    """Base node: override `process`; call `put` to emit downstream."""

    def __init__(self, name: str = ""):
        self.name = name
        self._handlers: list[Callable[[Any], None]] = []

    def add_sink(self, sink: "StreamProcessor"):
        self._handlers.append(sink.process)
        return sink

    def add_handler(self, fn: Callable[[Any], None]):
        self._handlers.append(fn)

    def put(self, obj):
        for h in self._handlers:
            h(obj)

    def process(self, obj):  # pragma: no cover - abstract
        self.put(obj)


class EnqueuerOutputHandler(StreamProcessor):
    """Collects outputs into a queue (StreamProcessor_EnqueuerOutputHandler)."""

    def __init__(self, name=""):
        super().__init__(name)
        self.queue: deque = deque()

    def process(self, obj):
        self.queue.append(obj)
        self.put(obj)


class FunctionProcessor(StreamProcessor):
    """Wrap a callable: emits fn(obj) when not None."""

    def __init__(self, fn, name=""):
        super().__init__(name)
        self.fn = fn

    def process(self, obj):
        out = self.fn(obj)
        if out is not None:
            self.put(out)


@boss.register(name="StreamProcessorGroup")
class StreamProcessorGroup:
    """Named pipeline: feed `process()`, objects flow first -> last node."""

    def __init__(self, name: str = "", objects=None, firstNode=None, lastNode=None):
        self.name = name
        self.objects = objects or []
        self.first = firstNode
        self.last = lastNode

    def node(self, name: str):
        for o in self.objects:
            if getattr(o, "name", None) == name:
                return o
        return None

    def process(self, obj):
        if self.first is not None:
            self.first.process(obj)

    @classmethod
    def from_boss(cls, data):
        return cls(
            name=data.get("name", ""),
            objects=data.get("objects", []),
            firstNode=data.get("firstNode"),
            lastNode=data.get("lastNode"),
        )


def chain(*processors: StreamProcessor) -> StreamProcessorGroup:
    """Wire processors sequentially into a group."""
    for a, b in zip(processors, processors[1:]):
        a.add_sink(b)
    return StreamProcessorGroup(
        name="chain", objects=list(processors),
        firstNode=processors[0] if processors else None,
        lastNode=processors[-1] if processors else None,
    )
