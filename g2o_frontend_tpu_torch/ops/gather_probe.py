"""Gathers inside a kernel: along lanes, along sublanes, and flat.

Counterpart of the Pallas probe kernels of
``scripts/profile_pallas_gather.py`` (``k_a``, ``k_b2``, ``k_c``), which
asked whether the TPU can gather arbitrarily inside a kernel. On Hopper the
answer is yes; these kernels measure how fast, at the probes' own shapes
and at the aligner's widths (``apps/profile_gather.py``).

- `take_along_lanes`, `take_along_sublanes` and `flat_gather` are the
  wrappers. On a CUDA tensor they launch the hand-written kernel
  ``csrc/gather_probe.cu`` (or raise); on a CPU tensor they take the plain
  version. They count their kernel launches in `launches`.
- `*_reference` are the plain PyTorch versions: `torch.gather` with the
  index wrap and NaN fill below.
- `projective_gather_sum` is kernel 2's gather in kernel 2's own pattern,
  without its arithmetic (``fused_aligner.fused_system_batch``'s inputs;
  per candidate the reference rows fetched and the wrapping sum of the bit
  patterns of every value loaded). Its time beside kernel 2's on the same
  inputs is kernel 2's memory traffic alone. It counts in `launches` too.

Semantics are ``jnp.take_along_axis``'s, which the Pallas kernels used: an
index in [-n, -1] counts from the end of its axis, and an index outside
[-n, n) gives NaN. Data is float32, indices int32.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import fused_aligner as fa

# kernel launches made by the wrappers on CUDA tensors since the last reset
launches = 0

SOURCE = cuda_build.CSRC / "gather_probe.cu"
_lib = None


def _gather_wrapped(x, dim, i):
    """torch.gather of `x` along `dim` at int32 indices `i`, with
    take_along_axis's wrap of negative indices and NaN for those out of range."""
    n = x.shape[dim]
    ok = (i >= -n) & (i < n)
    j = torch.where(ok, torch.where(i < 0, i + n, i), 0).long()
    return torch.where(ok, torch.gather(x, dim, j), float("nan"))


def take_along_lanes_reference(x, i):
    """out[r, c] = x[r, i[r, c]]; x (R, N) f32, i (R, C) int32."""
    return _gather_wrapped(x, 1, i)


def take_along_sublanes_reference(x, i):
    """out[r, c] = x[i[r, c], c]; x (N, C) f32, i (R, C) int32."""
    return _gather_wrapped(x, 0, i)


def flat_gather_reference(x, i, cols):
    """out[r, c] = x.ravel()[i[r, c]] for c < cols; x any f32 array, i (R, C)
    int32 with cols <= C."""
    return _gather_wrapped(x.reshape(-1), 0, i[:, :cols].reshape(-1)).reshape(i.shape[0], cols)


def _bit_sum(x):
    """The sum of the bit patterns of float32 `x`, modulo 2**32, as int64."""
    return x.view(torch.int32).to(torch.int64).sum() & 0xFFFFFFFF


def projective_gather_sum_reference(cur_packed, ref_tables, params, projector):
    """(K, 2) int32 [rows fetched, bit sum] of the kernel (see
    `projective_gather_sum`). Capturable in a CUDA graph: no host read."""
    cur_bits = _bit_sum(cur_packed)
    valid = cur_packed[7] > 0
    out = []
    for table, prm in zip(ref_tables, params):
        inside, idx = fa.project_to_reference(cur_packed[0:3], valid, prm, projector)
        inside = inside.reshape(-1, 1)
        rows = table[idx.reshape(-1)].view(torch.int32).to(torch.int64) * inside
        out.append(torch.stack([inside.sum(), (cur_bits + rows.sum()) & 0xFFFFFFFF]))
    sums = torch.stack(out)
    return torch.where(sums >= 2**31, sums - 2**32, sums).to(torch.int32)


def build():
    """Compile ``csrc/gather_probe.cu`` unless that build exists. Returns
    (library path, seconds spent compiling, nvcc's diagnostics)."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.gather_lanes_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gather_sublanes_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gather_flat_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.projective_gather_sum_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [ctypes.c_void_p]
        )
        for fn in (lib.gather_lanes_launch, lib.gather_sublanes_launch, lib.gather_flat_launch,
                   lib.projective_gather_sum_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device(x, name):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    return dev


def _check(x, i, x_ndim):
    if i.device != x.device:
        raise ValueError(f"i is on {i.device}, x on {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if i.dtype != torch.int32:
        raise ValueError(f"i must be int32, got {i.dtype}")
    if x_ndim is not None and x.ndim != x_ndim:
        raise ValueError(f"x must have {x_ndim} dimensions, got shape {tuple(x.shape)}")
    if i.ndim != 2:
        raise ValueError(f"i must have 2 dimensions, got shape {tuple(i.shape)}")
    if not (x.is_contiguous() and i.is_contiguous()):
        raise ValueError("x and i must be contiguous")
    if not (x.numel() < 2**31 and i.numel() < 2**31):
        raise ValueError("x and i must each hold fewer than 2**31 elements")


def _launch(name, x, i, out, *args):
    """Enqueue entry point `name` of the library on the current stream: its
    arguments are `args` (pointers and sizes) and the stream."""
    global launches
    dev = x.device
    with torch.cuda.device(dev):
        err = getattr(_load(), name)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    launches += 1
    return out


def take_along_lanes(x, i):
    """out[r, c] = x[r, i[r, c]] (``jnp.take_along_axis(x, i, axis=1)``);
    x (R, N) f32, i (R, C) int32 -> (R, C) f32.

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `take_along_lanes_reference`.
    """
    if _device(x, "take_along_lanes").type == "cpu":
        return take_along_lanes_reference(x, i)
    _check(x, i, 2)
    if i.shape[0] != x.shape[0]:
        raise ValueError(f"i {tuple(i.shape)} and x {tuple(x.shape)} differ in rows")
    (R, N), C = x.shape, i.shape[1]
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    return _launch("gather_lanes_launch", x, i, out, x.data_ptr(), i.data_ptr(), out.data_ptr(), R, N, C)


def take_along_sublanes(x, i):
    """out[r, c] = x[i[r, c], c] (``jnp.take_along_axis(x, i, axis=0)``);
    x (N, C) f32, i (R, C) int32 -> (R, C) f32.

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `take_along_sublanes_reference`.
    """
    if _device(x, "take_along_sublanes").type == "cpu":
        return take_along_sublanes_reference(x, i)
    _check(x, i, 2)
    if i.shape[1] != x.shape[1]:
        raise ValueError(f"i {tuple(i.shape)} and x {tuple(x.shape)} differ in columns")
    N, (R, C) = x.shape[0], i.shape
    out = torch.empty((R, C), dtype=torch.float32, device=x.device)
    return _launch("gather_sublanes_launch", x, i, out, x.data_ptr(), i.data_ptr(), out.data_ptr(), N, R, C)


def flat_gather(x, i, cols):
    """out[r, c] = x.ravel()[i[r, c]] for c < cols; x any f32 array, i (R, C)
    int32, cols <= C -> (R, cols) f32. Only the first `cols` columns of `i`
    are read.

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `flat_gather_reference`.
    """
    if _device(x, "flat_gather").type == "cpu":
        return flat_gather_reference(x, i, cols)
    _check(x, i, None)
    R, C = i.shape
    if not 0 <= cols <= C:
        raise ValueError(f"cols must lie in [0, {C}], got {cols}")
    out = torch.empty((R, cols), dtype=torch.float32, device=x.device)
    return _launch("gather_flat_launch", x, i, out, x.data_ptr(), x.numel(), i.data_ptr(), C, out.data_ptr(), R, cols)


def projective_gather_sum(cur_packed, ref_tables, params, projector):
    """Kernel 2's gather without its arithmetic: for each candidate k, every
    current pixel's 20 channels and, where the pixel projects into the
    reference image under params[k], the reference row there.

    cur_packed (20, H, W), ref_tables (K, H*W, 8) and params (K, 24) are
    float32, as ``fused_aligner.fused_system_batch`` takes them. Returns
    (K, 2) int32: the rows fetched, and the sum modulo 2**32 of the bit
    patterns of every value loaded (the current channels once per candidate,
    the fetched rows), which ties each count to the values read.

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `projective_gather_sum_reference`.
    """
    dev = _device(cur_packed, "projective_gather_sum")
    if dev.type == "cpu":
        return projective_gather_sum_reference(cur_packed, ref_tables, params, projector)
    H, W, K = projector.rows, projector.cols, ref_tables.shape[0]
    fa._check(cur_packed, ref_tables, params, H, W, K)
    if (H * W + 255) // 256 >= 2**16:
        raise ValueError(f"image size {H}x{W} exceeds the kernel's grid")
    out = torch.empty((K, 2), dtype=torch.int32, device=dev)
    return _launch("projective_gather_sum_launch", cur_packed, ref_tables, out, cur_packed.data_ptr(),
                   ref_tables.data_ptr(), params.data_ptr(), out.data_ptr(), K, H, W, projector.fx, projector.fy,
                   projector.cx, projector.cy, projector.min_distance, projector.max_distance)
