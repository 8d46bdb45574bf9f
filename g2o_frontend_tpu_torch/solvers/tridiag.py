"""Block-tridiagonal solves by cyclic reduction, the chain preconditioner
(counterpart of ``g2o_frontend_tpu/solvers/tridiag.py``).

Pose graphs are odometry chains plus sparse off-chain couplings (loop
closures). The block-tridiagonal part of the Hessian carries the chain's
long-range stiffness that stalls plain block-Jacobi PCG. Block cyclic
reduction eliminates it in log2(N) levels, each a batched d x d elimination
over the remaining even-indexed blocks: O(N) work, O(log N) depth. Factor
once per LM iteration, apply per CG iteration.

System: L[i] x[i-1] + D[i] x[i] + U[i] x[i+1] = r[i]; L and U are stored
independently (symmetry is not assumed).

The loops of `cr_factor` and `cr_solve` depend on shapes only and read
nothing from the host, so the solvers' CUDA graphs capture them as they
are (a Schur solve's head and each CG block).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CRFactor(NamedTuple):
    """Per-level elimination state (tuples indexed by level, coarse last)."""

    dinv_odd: tuple  # level l: (N_l/2, d, d) inverses of odd diagonal blocks
    l_odd: tuple  # odd-row lower blocks (N_l/2, d, d)
    u_odd: tuple  # odd-row upper blocks (N_l/2, d, d)
    a: tuple  # even-row left multipliers  -L_even Dinv_{left odd}
    c: tuple  # even-row right multipliers -U_even Dinv_{right odd}
    dinv_root: torch.Tensor  # (d, d)
    n: int  # padded block count, a power of two


def _inv(A):
    return torch.linalg.inv_ex(A, check_errors=False).inverse


def _pad_pow2(L, D, U):
    n = D.shape[-3]
    m = 1 << max(1, (n - 1).bit_length())
    if m == n:
        return L, D, U, n
    shape = D.shape[:-3] + (m - n,) + D.shape[-2:]
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device).expand(shape)
    zero = D.new_zeros(shape)
    return torch.cat([L, zero], -3), torch.cat([D, eye], -3), torch.cat([U, zero], -3), m


def _shift(x, zero):
    """Blocks shifted one place toward higher indices, `zero` in front."""
    return torch.cat([zero, x[..., :-1, :, :]], -3) if x.shape[-3] > 1 else zero


def cr_factor(L, D, U) -> CRFactor:
    """Factor a block-tridiagonal system for repeated solves.

    Args:
      L: (..., N, d, d) lower blocks; L[0] is ignored (no x[-1]).
      D: (..., N, d, d) diagonal blocks, assumed invertible (damped SPD in use).
      U: (..., N, d, d) upper blocks; U[N-1] is ignored.
    Leading axes, where there are any, index independent systems (the
    shards of a distributed chain, `parallel/spike.py`).
    """
    L, D, U, n = _pad_pow2(L, D, U)
    dinv_odd, l_odd, u_odd, aa, cc = [], [], [], [], []
    zero = D.new_zeros(D.shape[:-3] + (1,) + D.shape[-2:])
    while D.shape[-3] > 1:
        Do, Lo, Uo = D[..., 1::2, :, :], L[..., 1::2, :, :], U[..., 1::2, :, :]
        De, Le, Ue = D[..., 0::2, :, :], L[..., 0::2, :, :], U[..., 0::2, :, :]
        Dinv = _inv(Do)
        # even row 2k: its left odd neighbour is odd index k-1, its right k
        a = -(Le @ _shift(Dinv, zero))
        c = -(Ue @ Dinv)
        Dn = De + a @ _shift(Uo, zero) + c @ Lo
        Ln = a @ _shift(Lo, zero)
        Un = c @ Uo
        dinv_odd.append(Dinv)
        l_odd.append(Lo)
        u_odd.append(Uo)
        aa.append(a)
        cc.append(c)
        L, D, U = Ln, Dn, Un
    return CRFactor(tuple(dinv_odd), tuple(l_odd), tuple(u_odd), tuple(aa), tuple(cc), _inv(D[..., 0, :, :]), n)


def cr_solve(f: CRFactor, r):
    """Solve the factored system.

    Args:
      r: right-hand side of shape (..., N0, d) or (..., N0, d, m) for m
         simultaneous right-hand sides, with the factor's leading axes;
         N0 <= f.n.
    """
    squeeze = r.ndim == f.dinv_root.ndim
    if squeeze:
        r = r[..., None]
    n0 = r.shape[-3]
    if n0 < f.n:
        r = torch.cat([r, r.new_zeros(r.shape[:-3] + (f.n - n0,) + r.shape[-2:])], -3)
    zero = r.new_zeros(r.shape[:-3] + (1,) + r.shape[-2:])
    # down-sweep: reduce the right-hand side level by level, keeping each
    # level's odd rows
    r_odds = []
    for a, c in zip(f.a, f.c):
        ro, re = r[..., 1::2, :, :], r[..., 0::2, :, :]
        r_odds.append(ro)
        r = re + a @ _shift(ro, zero) + c @ ro
    x = (f.dinv_root @ r[..., 0, :, :]).unsqueeze(-3)
    # up-sweep: recover the odd unknowns, interleave them with the even ones
    for dinv, lo, uo, ro in zip(reversed(f.dinv_odd), reversed(f.l_odd), reversed(f.u_odd), reversed(r_odds)):
        # odd 2k+1: left even neighbour x[k], right even neighbour x[k+1]
        x_right = torch.cat([x[..., 1:, :, :], zero], -3)
        xo = dinv @ (ro - lo @ x - uo @ x_right)
        x = torch.stack([x, xo], -3).reshape(x.shape[:-3] + (-1,) + x.shape[-2:])
    x = x[..., :n0, :, :]
    return x[..., 0] if squeeze else x


def tridiag_solve(L, D, U, r):
    """One-shot factor + solve of an (N, d) right-hand side."""
    return cr_solve(cr_factor(L, D, U), r)
