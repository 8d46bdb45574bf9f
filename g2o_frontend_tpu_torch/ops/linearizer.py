"""Linearize stage of the z-buffer association: 29 Gauss-Newton sums of
correspondences that are already associated.

Counterpart of ``g2o_frontend_tpu/ops/pallas_linearizer.py`` (the Pallas
``_linearize_kernel`` reached through ``linearize_pallas``), which computes
the function of the JAX reference's ``_linearize``
(``g2o_frontend_tpu/pwn/aligner.py``): masked robust point+normal
linearization with the asymmetric robust scale (b and chi2 scale by
sqrt(max_chi2/chi2) above max_chi2, H does not; ``robust_kernel=False``
drops those correspondences instead).

- `linearize_system` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/linearizer.cu`` (or raises); on a CPU tensor it
  takes the plain version. It counts its kernel launches in `launches`.
- `linearize_system_reference` is the plain PyTorch version on the same
  inputs: ``fused_aligner.linearize_remapped``, the per-pixel algebra that
  the fused aligner applies after its gather (the two kernels share it
  too, in ``csrc/pwn_terms.cuh``).

Inputs: mask (H, W) bool; the reference point and normal per pixel already
mapped into the current frame, (3, H, W) each (as the Pallas kernel takes
them: near the optimum b sums nearly cancelling terms, so the remap is done
once, by the caller, with the rounding its gates saw); the current cloud
as the (20, H, W) planes of ``fused_aligner.pack_cur``. The sums come out
in ``_linearize_planar`` order: Htt 6, Htr 9, Hrr 6, b 6, chi2, inliers.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .fused_aligner import C_CUR, N_SUMS, linearize_remapped

# kernel launches made by `linearize_system` on CUDA tensors since the last reset
launches = 0

SOURCE = cuda_build.CSRC / "linearizer.cu"
_lib = None


def linearize_system_reference(mask, ref_pts, ref_nrm, cur_packed, cfg):
    """The plain PyTorch version of the kernel, on the kernel's inputs."""
    c = cur_packed
    return linearize_remapped(mask, ref_pts, ref_nrm, c[0:3], c[3:6], c[8:14], c[14:20], cfg)


def build():
    """Compile ``csrc/linearizer.cu`` unless that build exists. Returns
    (library path, seconds spent compiling, nvcc's diagnostics)."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.linearizer_blocks.argtypes = [ctypes.c_int]
        lib.linearizer_blocks.restype = ctypes.c_int
        lib.linearizer_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.linearizer_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(mask, ref_pts, ref_nrm, cur_packed):
    dev = cur_packed.device
    H, W = cur_packed.shape[1:]
    for name, x, shape, dtype in (
        ("mask", mask, (H, W), torch.bool),
        ("ref_pts", ref_pts, (3, H, W), torch.float32),
        ("ref_nrm", ref_nrm, (3, H, W), torch.float32),
        ("cur_packed", cur_packed, (C_CUR, H, W), torch.float32),
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cur_packed on {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < C_CUR * H * W < 2**31:
        raise ValueError(f"image size {H}x{W} out of the kernel's int32 range")


def linearize_system(mask, ref_pts, ref_nrm, cur_packed, cfg):
    """29 sums of the associated correspondences (see module docstring).

    A CUDA tensor launches the kernel on the current stream and does not
    synchronise; a CPU tensor takes `linearize_system_reference`.
    """
    global launches
    dev = cur_packed.device
    if dev.type == "cpu":
        return linearize_system_reference(mask, ref_pts, ref_nrm, cur_packed, cfg)
    if dev.type != "cuda":
        raise ValueError(f"linearize_system runs on CPU or CUDA tensors, got {dev}")
    _check(mask, ref_pts, ref_nrm, cur_packed)
    H, W = cur_packed.shape[1:]
    lib = _load()
    with torch.cuda.device(dev):
        block_sums = torch.empty((lib.linearizer_blocks(H * W), N_SUMS), dtype=torch.float32, device=dev)
        out = torch.empty(N_SUMS, dtype=torch.float32, device=dev)
        err = lib.linearizer_launch(
            mask.data_ptr(), ref_pts.data_ptr(), ref_nrm.data_ptr(), cur_packed.data_ptr(),
            block_sums.data_ptr(), out.data_ptr(), H, W, cfg.inlier_max_chi2, int(bool(cfg.robust_kernel)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"linearizer kernel launch failed: CUDA error {err}")
    launches += 1
    return out
