"""The native ``.g2o`` tokenizer, built from source and loaded with ctypes
(counterpart of ``g2o_frontend_tpu/native/__init__.py``).

``fastg2o.cpp`` is a byte-for-byte copy of the JAX package's. The library
is built with ``g++`` into ``_build/<hash>/libfastg2o.so``, keyed by the
source and the flags as `ops/cuda_build.py` keys the CUDA builds, so a
changed source rebuilds and nothing is written beside the source. A failed
build raises with the compiler's output: there is no silent fallback.
Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "fastg2o.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")
ABI = 2


class _CTable(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("rows", ctypes.c_long),
        ("cols", ctypes.c_long),
    ]


class _G2OResult(ctypes.Structure):
    _fields_ = [
        (n, _CTable)
        for n in (
            "vertex_se2",
            "vertex_xy",
            "vertex_se3",
            "edge_se2",
            "edge_se2_xy",
            "edge_se3",
            "fixed",
            "params",
            "features",
            "laser_meta",
            "laser_ranges",
            "vertex_line2d",
            "vertex_extreme",
            "edge_se2_line2d",
            "edge_line2d_xy",
        )
    ]


def build() -> Path:
    """Compile ``fastg2o.cpp`` into ``_build/<hash>/libfastg2o.so`` unless
    that build exists; returns the library's path. Raises RuntimeError
    with the compiler's output when the build fails."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / "libfastg2o.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libfastg2o.{os.getpid()}.tmp.so"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ could not build {SOURCE.name}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name} with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


_lib = None


def load_library():
    """The ctypes library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fastg2o_abi.restype = ctypes.c_long
        if int(lib.fastg2o_abi()) != ABI:
            raise RuntimeError(f"{SOURCE.name}: ABI {int(lib.fastg2o_abi())}, expected {ABI}")
        lib.fastg2o_parse.restype = ctypes.POINTER(_G2OResult)
        lib.fastg2o_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.fastg2o_free.argtypes = [ctypes.POINTER(_G2OResult)]
        _lib = lib
    return _lib


def parse_g2o_bytes(data: bytes):
    """Parse a .g2o byte buffer -> dict of numpy arrays."""
    import numpy as np

    lib = load_library()
    res = lib.fastg2o_parse(data, len(data))
    try:
        out = {}
        for name, _ in _G2OResult._fields_:
            t = getattr(res.contents, name)
            if t.rows and t.data:
                arr = np.ctypeslib.as_array(t.data, shape=(t.rows, t.cols)).copy()
            else:
                arr = np.zeros((0, t.cols if t.cols else 1))
            out[name] = arr
        return out
    finally:
        lib.fastg2o_free(res)
