"""The precisions the plain references compute in.

- ``float64``: the backend's reference (the optimum a solver is judged by).
- ``float32``: the precision the configurations state, IEEE float32 with
  every matrix product in full float32 (TF32 off).
- ``tf32``: the control, the next precision below float32: every matrix
  product's inputs rounded to TF32 (10 explicit mantissa bits, round to
  nearest even) and the product accumulated in float32, which is what a
  tensor core does with TF32 on. The rounding is done here, not left to
  cuBLAS, which may take a full float32 kernel for small products.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype(precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def no_tf32():
    """Full float32 matrix products in this process (PyTorch's default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x):
    """float32 `x` rounded to TF32's 10-bit mantissa, nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def mm(a, b, precision: str):
    """a @ b in `precision` (batched like torch.matmul)."""
    if precision == "tf32":
        return tf32_round(a.to(torch.float32)) @ tf32_round(b.to(torch.float32))
    return a @ b
