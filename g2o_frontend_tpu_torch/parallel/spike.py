"""Distributed block-tridiagonal solves: local cyclic reduction + SPIKE
(counterpart of ``g2o_frontend_tpu/parallel/spike.py``).

The chain preconditioner of the single-device solvers factors the global
odometry-chain tridiagonal (`solvers/tridiag.py`). Distributed, the chain
is block-partitioned in trajectory order, each shard cyclic-reduction
factors its OWN B-block tridiagonal, and the (D-1) boundary couplings are
handled by the SPIKE algorithm [Polizzi & Sameh 2006]:

    T = diag(T_s) + boundary couplings
    x_s = T_s^-1 r_s - W_s x_{s-1}[B-1] - V_s x_{s+1}[0]

with spikes ``W_s = T_s^-1 (e_0 (x) L_bnd)`` and
``V_s = T_s^-1 (e_{B-1} (x) U_bnd)`` factored once. The first and last
block rows of every shard give a small replicated interface system over
the 2D boundary unknowns (``(2D*d)^2``, 48x48 for D = 8 SE2 blocks),
assembled with one `psum` and LU-factored identically everywhere. A solve
is one local CR solve, one `psum` of 2 boundary blocks a shard, one
replicated triangular solve and a local rank-2 correction: O(D * d) bytes
on the wire, independent of N. Up to rounding the distributed T^-1 is the
single-device one.

The functions run on a mesh (`parallel/mesh.py`): every block leads with
the program's shard axis S, and the local factorizations of all S shards
are one batched cyclic reduction. The global chain is assumed symmetric
(U_bnd of shard s is the transpose of the L coupling seen by shard s+1),
which holds for Gauss-Newton Hessians.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..solvers.tridiag import CRFactor, cr_factor, cr_solve


class SpikeFactor(NamedTuple):
    fac: CRFactor  # local cyclic-reduction factors of the T_s, batched over S
    W: torch.Tensor  # (S, B, d, d) left spikes  T_s^-1 (e_0 (x) L_bnd)
    V: torch.Tensor  # (S, B, d, d) right spikes T_s^-1 (e_{B-1} (x) U_bnd)
    int_lu: tuple  # replicated (LU, pivots) of the (2D*d, 2D*d) interface matrix
    s_idx: torch.Tensor  # (S,) the mesh positions of the shards held here
    n_dev: int
    d: int


def spike_factor(L, Dm, U, U_bnd, mesh) -> SpikeFactor:
    """Factor the distributed chain for repeated solves.

    Args:
      L, Dm, U: (S, B, d, d) the shards' local block tridiagonals (internal
        couplings only; U[:, B-1] and L[:, 0] must be zero — boundary
        couplings go through U_bnd).
      U_bnd: (S, d, d) coupling of each shard's LAST block to the NEXT
        shard's first block (zero on the last shard and where no boundary
        edge exists). The left coupling is derived by symmetry through one
        `ppermute` of U_bnd.
      mesh: the mesh (`parallel/mesh.py`).
    """
    S, B, d = Dm.shape[0], Dm.shape[1], Dm.shape[-1]
    n_dev = mesh.size
    fac = cr_factor(L, Dm, U)

    # left coupling of shard s = (U_bnd of shard s-1)^T; the ring wraps the
    # last shard's (zero) U_bnd to shard 0, the "no left neighbour" case
    L_bnd = mesh.ppermute(U_bnd, 1).transpose(-1, -2)
    rhsW = Dm.new_zeros((S, B, d, d))
    rhsW[:, 0] = L_bnd
    rhsV = Dm.new_zeros((S, B, d, d))
    rhsV[:, B - 1] = U_bnd
    W = cr_solve(fac, rhsW)
    V = cr_solve(fac, rhsV)

    # interface system over u = [x_0[0], x_0[B-1], ..., x_{D-1}[B-1]]:
    #   x_s[0]   + W_s[0]   x_{s-1}[B-1] + V_s[0]   x_{s+1}[0] = y_s[0]
    #   x_s[B-1] + W_s[B-1] x_{s-1}[B-1] + V_s[B-1] x_{s+1}[0] = y_s[B-1]
    # Each shard scatters its four coupling blocks; the extra row/col D2 is
    # a dump slot for the (zero) blocks of the chain ends.
    s_idx = mesh.index()
    rows = torch.arange(S, device=Dm.device)
    D2 = 2 * n_dev
    colL = torch.where(s_idx > 0, 2 * s_idx - 1, D2)
    colR = torch.where(s_idx < n_dev - 1, 2 * s_idx + 2, D2)
    Aloc = Dm.new_zeros((S, D2 + 1, D2 + 1, d, d))
    Aloc.index_put_((rows, 2 * s_idx, colL), W[:, 0])
    Aloc.index_put_((rows, 2 * s_idx + 1, colL), W[:, B - 1])
    Aloc.index_put_((rows, 2 * s_idx, colR), V[:, 0])
    Aloc.index_put_((rows, 2 * s_idx + 1, colR), V[:, B - 1])
    A = mesh.psum(Aloc)[0, :D2, :D2]
    A = A.permute(0, 2, 1, 3).reshape(D2 * d, D2 * d) + torch.eye(D2 * d, dtype=Dm.dtype, device=Dm.device)
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    return SpikeFactor(fac, W, V, (LU, piv), s_idx, n_dev, d)


def spike_solve(sf: SpikeFactor, r, mesh):
    """Solve the factored distributed system for the shards' rows.

    Args:
      r: (S, B, d) or (S, B, d, m) right-hand-side rows.
      mesh: the mesh the factor was made on.
    Returns the solution rows, same shape. Communication: one psum of 2
    boundary blocks a shard (O(D*d*m) replicated bytes), nothing else.
    """
    squeeze = r.ndim == 3
    rr = r[..., None] if squeeze else r
    S, B, d, m = rr.shape
    y = cr_solve(sf.fac, rr)
    D2 = 2 * sf.n_dev
    rows = torch.arange(S, device=r.device)
    rhs_loc = rr.new_zeros((S, D2, d, m))
    rhs_loc.index_put_((rows, 2 * sf.s_idx), y[:, 0])
    rhs_loc.index_put_((rows, 2 * sf.s_idx + 1), y[:, B - 1])
    rhs = mesh.psum(rhs_loc)[0].reshape(D2 * d, m)
    u = torch.linalg.lu_solve(*sf.int_lu, rhs).reshape(D2, d, m)
    xl = u[torch.clamp(2 * sf.s_idx - 1, 0, D2 - 1)]  # W = 0 on shard 0
    xr = u[torch.clamp(2 * sf.s_idx + 2, 0, D2 - 1)]  # V = 0 on the last shard
    x = y - sf.W @ xl[:, None] - sf.V @ xr[:, None]
    return x[..., 0] if squeeze else x


def spike_solve_bytes(n_dev: int, d: int, m: int = 1, itemsize: int = 4):
    """Replicated psum payload per solve (the only wire traffic)."""
    return 2 * n_dev * d * m * itemsize
