"""nvcc builds of the port's CUDA sources (``csrc/*.cu``).

Each source compiles on its own into a shared library with a plain C
interface, loaded with ctypes by its wrapper module. A build goes into
``_build/<hash>/`` keyed by the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source rebuilds and an
unchanged one is reused. Nothing here runs at import: the CPU tests import
every module on machines with no CUDA toolkit.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build(source: Path):
    """Compile `source` into ``_build/<hash>/lib<stem>.so`` unless that build
    exists. Returns (library path, seconds spent compiling, nvcc's
    diagnostics)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / f"lib{source.stem}.so"
    if lib.is_file():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.tmp.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr
