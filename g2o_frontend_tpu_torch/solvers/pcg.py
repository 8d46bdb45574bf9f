"""Matrix-free preconditioned conjugate gradient over tuples of tensors
(counterpart of ``g2o_frontend_tpu/solvers/pcg.py``).

The solver never forms H: it needs only ``H @ v`` products and a
preconditioner, both supplied by the caller as functions on block vectors
(tuples of tensors). `max_iters` bounds the trip count and `rtol` stops it
early, with the semantics of the JAX version: iterate while ``k <
max_iters`` and ``r.z > rtol^2 * max(r0.z, 1e-30)``.

Two forms share the arithmetic (`cg_start`, `cg_step`):

- `pcg`, the eager loop: the stopping test read on the host once an
  iteration. No solver of the package calls it: every LM loop (the
  single-device solvers and those of `parallel/`) runs `cg_loop`. It
  stays as the plain form of the JAX version's loop, which the tests hold
  `pcg_blocked` and the JAX `pcg` to.
- `cg_loop`, the loop as a `utils.graphs.Loop` with the JAX test computed
  on the device: `graphs.while_loop` (and the solvers' `graphs.solve_loop`)
  runs it in blocks of `BLOCK` masked steps, one host read of the test a
  block, each block a CUDA graph replay on the card. A step after the stop
  changes no bit, so the blocked loop ends on the eager loop's x, r.z and
  count; `pcg_blocked` is its standalone form.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils import graphs

# CG iterations a block: one host read of the stopping test a block, at
# most BLOCK - 1 masked steps a solve (chosen on the card: PERF.md section 6)
BLOCK = 4


def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _axpy(alpha, x, y):
    """alpha * x + y"""
    return tuple(alpha * xl + yl for xl, yl in zip(x, y))


class CGCarry(NamedTuple):
    """The state of a CG iteration in a loop; `k` a 0-dim int64 tensor."""

    x: tuple
    r: tuple
    p: tuple
    rz: torch.Tensor
    k: torch.Tensor


def cg_start(b, precond: Callable, rtol: float, tree_dot: Callable | None = None):
    """(x0 = 0, r0, p0, r0.z0, the stopping threshold tol2 on r.z)."""
    tree_dot = _dot if tree_dot is None else tree_dot
    x = tuple(torch.zeros_like(bl) for bl in b)
    r = tuple(b)  # r = b - H x0 with x0 = 0
    z = precond(r)
    rz = tree_dot(r, z)
    return x, r, z, rz, rtol * rtol * torch.clamp_min(rz, 1e-30)


def cg_step(hvp: Callable, precond: Callable, x, r, p, rz, tree_dot: Callable | None = None):
    """One CG iteration: (x, r, p, r.z)."""
    tree_dot = _dot if tree_dot is None else tree_dot
    hp = hvp(p)
    php = tree_dot(p, hp)
    # guard against a non-PD direction (should not happen with LM damping)
    alpha = torch.where(php > 0, rz / torch.where(php > 0, php, 1e-30), 0.0)
    x = _axpy(alpha, p, x)
    r = _axpy(-alpha, hp, r)
    z = precond(r)
    rz_new = tree_dot(r, z)
    beta = rz_new / torch.where(rz > 0, rz, 1e-30)
    return x, r, _axpy(beta, p, z), rz_new


def cg_carry(b, precond: Callable, rtol: float, tree_dot: Callable | None = None):
    """(the `CGCarry` at x0 = 0, tol2): `cg_start` with k = 0 on the device."""
    x, r, p, rz, tol2 = cg_start(b, precond, rtol, tree_dot)
    return CGCarry(x, r, p, rz, torch.zeros((), dtype=torch.int64, device=rz.device)), tol2


def pcg(hvp: Callable, b, precond: Callable, *, max_iters: int = 100, rtol: float = 1e-6,
        tree_dot: Callable | None = None):
    """Solve ``H x = b`` with preconditioned CG, reading the stopping test on
    the host once an iteration.

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
    x, r, p, rz, tol2 = cg_start(b, precond, rtol, tree_dot)
    k = 0
    while k < max_iters and bool(rz > tol2):
        x, r, p, rz = cg_step(hvp, precond, x, r, p, rz, tree_dot)
        k += 1
    return x, k, rz


def cg_loop(operators: Callable, tol2_of: Callable, max_iters: int, block: int | None = None,
            tree_dot: Callable | None = None) -> graphs.Loop:
    """CG as a `graphs.Loop` over `CGCarry`: ``operators(consts)`` gives
    (hvp, precond), ``tol2_of(consts)`` the threshold; the test is the JAX
    version's ``k < max_iters & r.z > tol2``. `tree_dot` is `pcg`'s; it
    reads no tensor but its arguments (a distributed solver's dot over the
    shards of its mesh)."""

    def cond(consts, c):
        return (c.k < max_iters) & (c.rz > tol2_of(consts))

    def body(consts, c):
        hvp, precond = operators(consts)
        return CGCarry(*cg_step(hvp, precond, c.x, c.r, c.p, c.rz, tree_dot), c.k + 1)

    return graphs.Loop(cond, body, max_iters, BLOCK if block is None else block)


def pcg_blocked(hvp: Callable, b, precond: Callable, *, consts=(), max_iters: int = 100, rtol: float = 1e-6,
                block: int | None = None):
    """`pcg` through `graphs.while_loop`: ``hvp(consts, v)`` and
    ``precond(consts, r)`` take the tensors they read as `consts` (a tree),
    so that a graph of a block reads them from its static buffers.

    Returns:
      (x, iters, final_rz): iters a 0-dim int64 tensor on b's device.
    """
    c, tol2 = cg_carry(b, lambda r: precond(consts, r), rtol)
    loop = cg_loop(lambda cs: (lambda v: hvp(cs[0], v), lambda r: precond(cs[0], r)), lambda cs: cs[1], max_iters,
                   block)
    c = graphs.while_loop("pcg", loop, (consts, tol2), c)
    return c.x, c.k, c.rz
