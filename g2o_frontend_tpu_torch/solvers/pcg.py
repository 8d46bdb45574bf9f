"""Matrix-free preconditioned conjugate gradient over tuples of tensors
(counterpart of ``g2o_frontend_tpu/solvers/pcg.py``).

The solver never forms H: it needs only ``H @ v`` products and a
preconditioner, both supplied by the caller as functions on block vectors
(tuples of tensors). `max_iters` bounds the trip count and `rtol` stops it
early, with the semantics of the JAX version: iterate while ``k <
max_iters`` and ``r.z > rtol^2 * max(r0.z, 1e-30)``.

The loop tests the stopping rule on the host, one read of ``r.z`` per
iteration; the JAX version runs the same test inside a ``while_loop`` on the
device.
"""
from __future__ import annotations

from typing import Callable

import torch


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _axpy(alpha, x, y):
    """alpha * x + y"""
    return tuple(alpha * xl + yl for xl, yl in zip(x, y))


def pcg(hvp: Callable, b, precond: Callable, *, max_iters: int = 100, rtol: float = 1e-6,
        tree_dot: Callable | None = None):
    """Solve ``H x = b`` with preconditioned CG.

    Args:
      hvp: function v -> H @ v on the block vector (a tuple of tensors).
      b: right-hand side, a tuple of tensors.
      precond: function r -> M^{-1} r (e.g. block-Jacobi).
      max_iters: the most iterations.
      rtol: relative residual tolerance on sqrt(r.z).
      tree_dot: optional replacement inner product, returning a 0-dim
        tensor: a distributed solver passes a dot that sums over the shards
        of its block vectors (`parallel/partitioned_pose_graph.py`), so
        that every shard reads the same stopping test.

    Returns:
      (x, iters, final_rz): iters is a Python int, final_rz a 0-dim tensor.
    """
    if tree_dot is None:
        tree_dot = _dot
    x = tuple(torch.zeros_like(bl) for bl in b)
    r = tuple(b)  # r = b - H x0 with x0 = 0
    z = precond(r)
    p = z
    rz = tree_dot(r, z)
    tol2 = rtol * rtol * torch.clamp_min(rz, 1e-30)
    k = 0
    while k < max_iters and bool(rz > tol2):
        hp = hvp(p)
        php = tree_dot(p, hp)
        # guard against a non-PD direction (should not happen with LM damping)
        alpha = torch.where(php > 0, rz / torch.where(php > 0, php, 1e-30), 0.0)
        x = _axpy(alpha, p, x)
        r = _axpy(-alpha, hp, r)
        z = precond(r)
        rz_new = tree_dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, 1e-30)
        p = _axpy(beta, p, z)
        rz = rz_new
        k += 1
    return x, k, rz
