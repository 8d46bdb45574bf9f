"""The SE3 pose graph's inner PCG, one kernel launch an LM iteration: the
port's counterpart of the ``pcg`` ``while_loop`` under the JAX package's
``solvers/pose_graph.optimize_se3`` (XLA, no Pallas kernel).

- `System` holds one LM iteration's damped Gauss-Newton system as the CG
  reads it: the edges' Jacobians and weights, their segment indices, the
  block diagonal, lambda, the free poses and the preconditioner (the
  block-Jacobi inverses or the chain's `tridiag.CRFactor`).
- `hvp` and `precondition` are its operators in plain PyTorch: the
  product ``H v`` (LM damping on the diagonal blocks, zero on fixed and
  padded poses) and ``M^-1 r``.
- `solve(system, b, rtol, max_iters)` solves ``H x = b`` from x = 0 and
  returns the last `pcg.CGCarry`, with the JAX test ``k < max_iters & r.z
  > rtol^2 max(r0.z0, 1e-30)`` and `pcg.cg_step`'s arithmetic. On a CUDA
  tensor it launches the hand-written kernel ``csrc/se3_pcg.cu`` (or
  raises): the whole loop, start included, in one launch with no host
  read, so a solve's head graph captures it. On a CPU tensor it takes
  `solve_reference`. It counts its launches in `launches`.
- `solve_reference` is the plain version: `pcg.cg_carry` and `max_iters`
  masked steps of `pcg.cg_loop` over `hvp` and `precondition`; a step
  after the stop changes no bit, so it ends on the eager loop's carry.
- `layout` is the kernel's choice of shared memory or scratch for its
  vectors and edge terms, from the shapes alone, in Python so that the CPU
  tests reach it; `_load` checks its constants against the source's.
- `off_diagonal`, `ranks` and `pack_factor` make the kernel's inputs: the
  edges' off-diagonal blocks ``Ji^T W Jj``, each edge's rank in the
  segment order of its two poses, the chain factor's levels in one
  buffer.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ..solvers import pcg, tridiag
from ..utils import graphs
from . import cuda_build
from . import segment_sum as ss

# kernel launches made by `solve` on CUDA tensors since the last reset
launches = 0

SOURCE = cuda_build.CSRC / "se3_pcg.cu"
_lib = None

# The kernel's geometry (csrc/se3_pcg.cu, checked against its
# se3_pcg_constants at load): one block of THREADS threads; at most
# MAX_SMEM bytes of dynamic shared memory, the first RED_FLOATS floats
# the dot products' partials; TERMS floats of H v terms an edge.
THREADS = 512
MAX_SMEM = 227 * 1024
RED_FLOATS = 64
TERMS = 12
INT32_MAX = 2**31 - 1


class System(NamedTuple):
    """One LM iteration's damped system of an SE3 pose graph of NP poses
    and EP edges (float32)."""

    Ji: torch.Tensor  # (EP, 6, 6) d e / d x_i
    Jj: torch.Tensor  # (EP, 6, 6) d e / d x_j
    w: torch.Tensor  # (EP, 6, 6) information, robust-scaled and masked
    I_seg: ss.SegmentIndex  # the edges' first poses into NP rows
    J_seg: ss.SegmentIndex  # their second poses
    Dp: torch.Tensor  # (NP, 6, 6) the undamped block diagonal
    lam: torch.Tensor  # () LM damping
    free: torch.Tensor  # (NP,) 1 on free poses, 0 on fixed and padded ones
    pre: torch.Tensor | tridiag.CRFactor  # (NP, 6, 6) block-Jacobi inverses, or the chain's factor


def hvp(s: System, v: torch.Tensor) -> torch.Tensor:
    """``H v`` for v (NP, 6): the edges' Gauss-Newton product plus lambda
    times the diagonal blocks, of v taken on free poses, on free poses;
    zero on the others."""
    I, J = s.I_seg.index, s.J_seg.index
    vp = v * s.free[:, None]
    Jv = torch.einsum("kdi,ki->kd", s.Ji, vp[I]) + torch.einsum("kdi,ki->kd", s.Jj, vp[J])
    WJv = torch.einsum("kde,ke->kd", s.w, Jv)
    hp = ss.segment_sum(torch.einsum("kdi,kd->ki", s.Ji, WJv), s.I_seg) + ss.segment_sum(
        torch.einsum("kdi,kd->ki", s.Jj, WJv), s.J_seg
    )
    hp = hp + s.lam * torch.einsum("kij,kj->ki", s.Dp, vp)
    return hp * s.free[:, None] + (1.0 - s.free)[:, None] * vp


def precondition(s: System, r: torch.Tensor) -> torch.Tensor:
    """``M^-1 r`` for r (NP, 6)."""
    if isinstance(s.pre, tridiag.CRFactor):
        return tridiag.cr_solve(s.pre, r)
    return torch.einsum("kij,kj->ki", s.pre, r)


def solve_reference(s: System, b: torch.Tensor, rtol: float, max_iters: int) -> pcg.CGCarry:
    """The plain version of `solve`: `max_iters` masked CG steps."""
    ops = (lambda v: (hvp(s, v[0]),), lambda r: (precondition(s, r[0]),))
    carry, tol2 = pcg.cg_carry((b,), ops[1], rtol)
    return graphs.masked_block(pcg.cg_loop(lambda _: ops, lambda _: tol2, max_iters, block=max_iters), None, carry)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the kernel keeps its work for NP poses, n preconditioner rows
    and EP edges: the vectors x, r, p, Hp ((NP, 6) each), z ((n, 6)) and
    the free mask (NP,) in shared memory if `vectors_shared`, the edges'
    (EP, 12) terms if `terms_shared`, the rest in a scratch buffer of
    `scratch_floats`; `smem` bytes of dynamic shared memory."""

    NP: int
    n: int
    EP: int
    vectors_shared: bool
    terms_shared: bool
    smem: int
    scratch_floats: int


def layout(NP: int, n: int, EP: int) -> Layout:
    """The kernel's `Layout`: the vectors in shared memory where they fit
    beside the partials, then the edge terms where they fit too. Raises
    ValueError for sizes beyond the kernel's int32 indexing."""
    if not (1 <= NP <= n and 0 <= EP) or max(36 * EP, 180 * n) > INT32_MAX:
        raise ValueError(f"{NP} poses, {n} preconditioner rows and {EP} edges are out of the kernel's range")
    vec, terms = (4 * NP + n) * 6 + NP, EP * TERMS
    vec_sh = (RED_FLOATS + vec) * 4 <= MAX_SMEM
    terms_sh = vec_sh and (RED_FLOATS + vec + terms) * 4 <= MAX_SMEM
    smem = 4 * (RED_FLOATS + (vec if vec_sh else 0) + (terms if terms_sh else 0))
    return Layout(NP, n, EP, vec_sh, terms_sh, smem, (0 if vec_sh else vec) + (0 if terms_sh else terms))


def off_diagonal(s: System) -> torch.Tensor:
    """(EP, 6, 6): each edge's block ``Ji^T W Jj`` of H, row i(e), column
    j(e) (the transpose at row j(e), column i(e))."""
    return torch.einsum("kdi,kde,kej->kij", s.Ji, s.w, s.Jj).contiguous()


def ranks(seg: ss.SegmentIndex) -> torch.Tensor:
    """(E,) int32: each row's rank in the segment index's stable order."""
    order = seg.order.long()
    return torch.empty_like(seg.order).index_put_((order,), torch.arange(order.shape[0], dtype=torch.int32,
                                                                          device=order.device))


def pack_factor(f: tridiag.CRFactor) -> torch.Tensor:
    """The chain factor's levels in one buffer: level l's dinv, l, u, a
    and c ((n / 2^(l+1), 6, 6) each) at 180 (n - n / 2^l) floats, then the
    root's inverse."""
    parts = [t.reshape(-1) for level in zip(f.dinv_odd, f.l_odd, f.u_odd, f.a, f.c) for t in level]
    return torch.cat(parts + [f.dinv_root.reshape(-1)])


def build():
    """Compile ``csrc/se3_pcg.cu`` unless that build exists. Returns
    (library path, seconds spent compiling, nvcc's diagnostics)."""
    return cuda_build.build(SOURCE)


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        err = lib.se3_pcg_init()
        if err != 0:
            raise RuntimeError(f"se3_pcg_init failed: CUDA error {err}")
        got = (ctypes.c_int * 4)()
        got = tuple(got[:lib.se3_pcg_constants(got)])
        want = (THREADS, MAX_SMEM, RED_FLOATS, TERMS)
        if got != want:
            raise RuntimeError(f"{SOURCE.name}'s geometry {got} is not the wrapper's {want}")
        lib.se3_pcg_launch.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float]
                                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.se3_pcg_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(s: System, b: torch.Tensor):
    """(NP, EP) after checking every tensor's dtype, device and shape."""
    NP, EP = b.shape[0] if b.ndim == 2 else -1, s.Ji.shape[0]
    named = dict(b=(b, (NP, 6)), Ji=(s.Ji, (EP, 6, 6)), Jj=(s.Jj, (EP, 6, 6)), w=(s.w, (EP, 6, 6)),
                 Dp=(s.Dp, (NP, 6, 6)), lam=(s.lam, ()), free=(s.free, (NP,)))
    if isinstance(s.pre, tridiag.CRFactor):
        if s.pre.dinv_root.shape != (6, 6) or s.pre.n < NP:
            raise ValueError(f"the chain factor must be of one system of at least {NP} rows of 6")
        named.update({f"factor {i}": (t, t.shape) for i, t in enumerate(graphs.flatten(s.pre)[1])})
    else:
        named["pre"] = (s.pre, (NP, 6, 6))
    for name, (t, shape) in named.items():
        if t.dtype != torch.float32:
            raise ValueError(f"se3_pcg takes float32 tensors, got {name} as {t.dtype}")
        if t.device != b.device:
            raise ValueError(f"se3_pcg takes tensors on one device, got {name} on {t.device} and b on {b.device}")
        if tuple(t.shape) != tuple(shape) or NP < 1:
            raise ValueError(f"se3_pcg: {name} has shape {tuple(t.shape)}, wants {tuple(shape)}")
    for name, seg in (("I_seg", s.I_seg), ("J_seg", s.J_seg)):
        if seg.n != NP or seg.index.shape != (EP,) or seg.device != b.device:
            raise ValueError(f"se3_pcg: {name} must index {EP} edges into {NP} poses on {b.device}")
    return NP, EP


def solve(s: System, b: torch.Tensor, rtol: float, max_iters: int) -> pcg.CGCarry:
    """``H x = b`` by PCG from x = 0 (see the module docstring): the last
    `pcg.CGCarry` (x, r and p one-tuples of (NP, 6), r.z and the step count
    k, 0-dim). A CUDA tensor launches the kernel on the current stream and
    does not synchronise; a CPU tensor takes `solve_reference`."""
    global launches
    NP, EP = _check(s, b)
    if b.device.type == "cpu":
        return solve_reference(s, b, rtol, max_iters)
    if b.device.type != "cuda":
        raise ValueError(f"se3_pcg runs on CPU or CUDA tensors, got {b.device}")
    chain = isinstance(s.pre, tridiag.CRFactor)
    n = s.pre.n if chain else NP
    lay = layout(NP, n, EP)
    dev = b.device
    B = off_diagonal(s)
    ends = torch.stack([s.I_seg.index, s.J_seg.index], 1).to(torch.int32)
    pos_i, pos_j = ranks(s.I_seg), ranks(s.J_seg)
    pre = pack_factor(s.pre) if chain else s.pre.contiguous()
    lib = _load()
    x, r, p = (torch.empty((NP, 6), dtype=torch.float32, device=dev) for _ in range(3))
    rz = torch.empty((), dtype=torch.float32, device=dev)
    k = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(max(lay.scratch_floats, 1), dtype=torch.float32, device=dev)
    bc, Dp, free, lam = b.contiguous(), s.Dp.contiguous(), s.free.contiguous(), s.lam.contiguous()
    with torch.cuda.device(dev):
        err = lib.se3_pcg_launch(
            B.data_ptr(), ends.data_ptr(), pos_i.data_ptr(), pos_j.data_ptr(), s.I_seg.offsets.data_ptr(),
            s.J_seg.offsets.data_ptr(), Dp.data_ptr(), lam.data_ptr(), free.data_ptr(),
            pre.data_ptr(), bc.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), rz.data_ptr(), k.data_ptr(),
            scratch.data_ptr(), NP, EP, n, int(chain), max_iters, rtol * rtol, int(lay.vectors_shared),
            int(lay.terms_shared), lay.smem, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"se3_pcg kernel launch failed: CUDA error {err} ({lay})")
    launches += 1
    return pcg.CGCarry((x,), (r,), (p,), rz, k)
