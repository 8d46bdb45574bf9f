"""boss-style serialization: JSON object logs with #id/#pointer references
(the port's copy of ``g2o_frontend_tpu/io/boss.py``, numpy only; its code is
the JAX module's, so both packages read a file to the same objects).

This module holds the port's own registry: the port's config classes
(``pwn/pipeline.py``, ``graph/pipeline.py``) register here under the
reference class names, and never into the JAX package's registry.

Re-implementation of the reference "boss" layer (``boss/serializer.h:34-81``,
``boss/deserializer.h:40``, ``boss/serializable.h``, ``boss/blob.h``) as a
Python registry + JSON-lines format, wire-compatible with the reference's
log/config syntax:

    "ClassName" { "#id" : 3, "field" : 1.5, "other" : { "#pointer" : 7 } }

one object per line; cross-references by integer id, resolved after the whole
stream is read (the reference's `deserializeComplete` phase); binary payloads
live in side files referenced by path (`BLOBReference`, lazily loaded on
`get()`, ``blob.h:88-98``).

This is the checkpoint/resume backbone (SURVEY.md §5) and the config system:
the reference declares whole pipelines as serialized object graphs
(``pwn_tracker2/conf/*.conf``) — `Deserializer` reads those files directly,
and `register(name=...)` lets our TPU components claim the reference class
names so existing configs instantiate the new framework.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import fields, is_dataclass
from typing import Any, Callable

import numpy as np

# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_FACTORIES: dict[str, Callable] = {}


def register(cls=None, *, name: str | None = None, aliases: tuple = ()):
    """Class decorator: register under its name (+ aliases) for the factory.

    Mirrors ``BOSS_REGISTER_CLASS`` (``serializable.h:80-84``)."""

    def wrap(c):
        c._boss_name = name or c.__name__
        for n in (c._boss_name, *aliases):
            _REGISTRY[n] = c
        return c

    return wrap(cls) if cls is not None else wrap


def register_factory(name: str, fn: Callable):
    """Register a custom construction function for a class name."""
    _FACTORIES[name] = fn


def known_classes():
    return sorted(set(_REGISTRY) | set(_FACTORIES))


class Pointer:
    """Unresolved #pointer placeholder (resolved in the complete phase)."""

    __slots__ = ("id",)

    def __init__(self, id_: int):
        self.id = id_

    def __repr__(self):
        return f"Pointer({self.id})"


# ---------------------------------------------------------------------------
# BLOBs
# ---------------------------------------------------------------------------


class BlobRef:
    """Lazy reference to a binary side file (npz / npy / image).

    `get()` loads on first access, like ``BLOBReference<T>::get()``.
    Reference-format image payloads decode straight into numpy arrays:
    pgm (mono8/mono16), ppm/pbm (rgb8) and grayscale png — the ImageBLOB
    wire formats of ``boss_map/image_sensor.cpp:17-101``.
    """

    IMAGE_EXTS = (".pgm", ".ppm", ".pbm", ".png")

    def __init__(self, path: str, base_dir: str = ".", data=None, ext=None):
        self.path = path
        self.base_dir = base_dir
        self._data = data
        self.ext = ext  # preferred encoding for pending in-memory data

    @classmethod
    def from_array(cls, img, ext: str = None) -> "BlobRef":
        """Pending image/array BLOB: path assigned when a Serializer writes
        it (the analog of constructing an ImageBLOB before serialization)."""
        img = np.asarray(img)
        if ext is None:
            if img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
                ext = "pgm"
            elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
                ext = "pbm"
            else:
                ext = "npy"
        return cls("", data=img, ext=ext)

    def get(self):
        if self._data is None:
            full = os.path.join(self.base_dir, self.path)
            ext = os.path.splitext(full)[1].lower()
            if ext == ".npz":
                self._data = dict(np.load(full))
            elif ext == ".npy":
                self._data = np.load(full)
            elif ext in self.IMAGE_EXTS:
                from .image_codec import decode_image

                with open(full, "rb") as fh:
                    self._data = decode_image(fh.read(), ext)
            else:
                with open(full, "rb") as fh:
                    self._data = fh.read()
        return self._data

    def release(self):
        """Drop the cached payload (cache eviction, ``blob.h`` BLOB::release)."""
        self._data = None


# ---------------------------------------------------------------------------
# line parser:  "ClassName" { ...json... }
# ---------------------------------------------------------------------------

_LINE_RE = re.compile(r'^\s*"([^"]+)"\s*(\{.*\})\s*$', re.S)


def parse_boss_line(line: str):
    """-> (class_name, dict) or None for blank/comment lines."""
    if not line.strip() or line.strip().startswith(("#", "//")):
        return None
    m = _LINE_RE.match(line)
    if not m:
        raise ValueError(f"malformed boss line: {line[:80]!r}")
    return m.group(1), json.loads(m.group(2))


def format_boss_line(class_name: str, data: dict) -> str:
    return f'"{class_name}" {json.dumps(data)}'


# ---------------------------------------------------------------------------
# (de)serializer
# ---------------------------------------------------------------------------


def _decode_value(v, base_dir):
    if isinstance(v, dict):
        if "#pointer" in v:
            p = v["#pointer"]
            return None if p == -1 else Pointer(int(p))
        if "#blob" in v:
            return BlobRef(v["#blob"], base_dir)
        if "values" in v and len(v) == 1 and isinstance(v["values"], list):
            return np.asarray(v["values"], dtype=np.float64)
        return {k: _decode_value(x, base_dir) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_value(x, base_dir) for x in v]
    return v


class Deserializer:
    """Read a boss log/config; instantiate registered classes, resolve refs.

    Unknown class names are kept as plain dicts (so logs remain inspectable
    even without every component registered)."""

    def __init__(self, path_or_lines):
        if isinstance(path_or_lines, (list, tuple)):
            self.lines = list(path_or_lines)
            self.base_dir = "."
        else:
            with open(path_or_lines) as fh:
                self.lines = fh.readlines()
            self.base_dir = os.path.dirname(os.path.abspath(path_or_lines))
        self.objects: list[Any] = []
        self.by_id: dict[int, Any] = {}
        self.by_name: dict[str, Any] = {}

    def read_all(self):
        raw = []
        for line in self.lines:
            parsed = parse_boss_line(line)
            if parsed is None:
                continue
            cname, data = parsed
            data = {k: _decode_value(v, self.base_dir) for k, v in data.items()}
            oid = data.pop("#id", None)
            obj = self._instantiate(cname, data)
            if oid is not None:
                self.by_id[int(oid)] = obj
            nm = data.get("name")
            if isinstance(nm, str):
                self.by_name[nm] = obj
            raw.append(obj)
        self.objects = raw
        self._resolve(raw)
        for o in raw:
            hook = getattr(o, "deserialize_complete", None)
            if callable(hook):
                hook()
        return raw

    def _instantiate(self, cname, data):
        if cname in _FACTORIES:
            return _FACTORIES[cname](data)
        cls = _REGISTRY.get(cname)
        if cls is None:
            return {"#class": cname, **data}
        if hasattr(cls, "from_boss"):
            return cls.from_boss(data)
        if is_dataclass(cls):
            names = {f.name for f in fields(cls)}
            kw = {k: v for k, v in data.items() if k in names}
            obj = cls(**kw)
            for k, v in data.items():
                if k not in names:
                    try:
                        setattr(obj, k, v)
                    except Exception:
                        pass
            return obj
        obj = cls.__new__(cls)
        obj.__dict__.update(data)
        return obj

    def _resolve(self, objs):
        def fix(v):
            if isinstance(v, Pointer):
                return self.by_id.get(v.id, v)
            if isinstance(v, list):
                return [fix(x) for x in v]
            if isinstance(v, dict):
                return {k: fix(x) for k, x in v.items()}
            return v

        for o in objs:
            if isinstance(o, dict):
                for k in list(o.keys()):
                    o[k] = fix(o[k])
            else:
                d = getattr(o, "__dict__", None)
                if d is not None:
                    for k in list(d.keys()):
                        d[k] = fix(d[k])
                elif is_dataclass(o):
                    for f in fields(o):
                        object.__setattr__(o, f.name, fix(getattr(o, f.name)))


class Serializer:
    """Write objects as a boss log; assigns ids, emits #pointer refs.

    `blob_dir` receives binary payloads as .npy/.npz side files."""

    def __init__(self, path, blob_dir: str | None = None):
        self.path = path
        self.blob_dir = blob_dir or os.path.splitext(path)[0] + ".d"
        self._fh = open(path, "w")
        self._ids: dict[int, int] = {}
        self._next = 0
        self._n_blobs = 0
        # Written objects are pinned: id()-keyed dedup would otherwise
        # confuse a new object reusing a freed address with an old one.
        self._keepalive: list = []
        self._written: set = set()

    def _id_of(self, obj):
        key = id(obj)
        if key not in self._ids:
            self._ids[key] = self._next
            self._next += 1
        return self._ids[key]

    def _encode_value(self, v, queue):
        if isinstance(v, BlobRef):
            if v._data is not None and not v.path:
                # pending in-memory payload (BlobRef.from_array): persist it
                # in the requested wire format (image_sensor.cpp:84-101)
                os.makedirs(self.blob_dir, exist_ok=True)
                ext = (v.ext or "npy").lstrip(".")
                # write into blob_dir itself; the '#blob' field stores the
                # path relative to the log file (works for non-sibling dirs)
                full = os.path.join(self.blob_dir, f"blob_{self._n_blobs}.{ext}")
                rel = os.path.relpath(full, os.path.dirname(self.path) or ".")
                if ext in ("pgm", "ppm", "pbm", "png"):
                    from .image_codec import encode_image

                    with open(full, "wb") as fh:
                        fh.write(encode_image(v._data, ext))
                else:
                    np.save(full, v._data)
                self._n_blobs += 1
                v.path = rel
                v.base_dir = os.path.dirname(self.path) or "."
            return {"#blob": v.path}
        if isinstance(v, np.ndarray):
            if v.size > 64:
                os.makedirs(self.blob_dir, exist_ok=True)
                full = os.path.join(self.blob_dir, f"blob_{self._n_blobs}.npy")
                np.save(full, v)
                rel = os.path.relpath(full, os.path.dirname(self.path) or ".")
                self._n_blobs += 1
                return {"#blob": rel}
            return {"values": [float(x) for x in v.reshape(-1)]}
        if isinstance(v, (bool, int, float, str)) or v is None:
            return v
        if isinstance(v, (list, tuple)):
            return [self._encode_value(x, queue) for x in v]
        if isinstance(v, dict):
            return {k: self._encode_value(x, queue) for k, x in v.items()}
        # object reference
        queue.append(v)
        return {"#pointer": self._id_of(v)}

    def write(self, obj, class_name: str | None = None):
        queue: list = []
        self._write_one(obj, class_name, queue)
        while queue:
            nxt = queue.pop(0)
            if id(nxt) in self._written:
                continue
            self._write_one(nxt, None, queue)

    def _write_one(self, obj, class_name, queue):
        if id(obj) in self._written:
            return
        self._written.add(id(obj))
        self._keepalive.append(obj)
        # _boss_name only when set on the exact class: an unregistered
        # subclass must serialize under its own name, not its parent's
        cname = class_name or type(obj).__dict__.get(
            "_boss_name", type(obj).__name__
        )
        if hasattr(obj, "to_boss"):
            data = obj.to_boss()
        elif is_dataclass(obj):
            data = {f.name: getattr(obj, f.name) for f in fields(obj)}
        elif isinstance(obj, dict):
            data = {k: v for k, v in obj.items() if k != "#class"}
            cname = obj.get("#class", cname)
        else:
            data = dict(getattr(obj, "__dict__", {}))
        enc = {"#id": self._id_of(obj)}
        for k, v in data.items():
            enc[k] = self._encode_value(v, queue)
        self._fh.write(format_boss_line(cname, enc) + "\n")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
