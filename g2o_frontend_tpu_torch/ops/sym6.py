"""Symmetric 3x3 matrices as 6 leading channels (counterpart of
``g2o_frontend_tpu/ops/sym6.py``).

Per-pixel symmetric matrices are kept channel-planar, a (6, H, W) tensor of
the upper triangle (xx, xy, xz, yy, yz, zz), so that per-pixel algebra is
elementwise over (H, W) planes and the layout matches the JAX reference's
`Cloud`. Functions take leading-channel tensors or tuples of planes;
rotations are small dense (3, 3) tensors.
"""
from __future__ import annotations

import torch

# upper-triangle index pairs in channel order
IDX = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def sym_pack(M):
    """(..., 3, 3) symmetric -> (6, ...) channels."""
    return torch.stack([M[..., i, j] for i, j in IDX])


def sym_mat(o):
    """(6, ...) channels -> (..., 3, 3) full matrix."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    rows = [(xx, xy, xz), (xy, yy, yz), (xz, yz, zz)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sym_apply(o, v):
    """(6, ...) @ 3-channel vector -> 3-channel tuple."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    return (
        xx * v[0] + xy * v[1] + xz * v[2],
        xy * v[0] + yy * v[1] + yz * v[2],
        xz * v[0] + yz * v[1] + zz * v[2],
    )


def sym_rotate(R, o):
    """R O R^T for a (3, 3) rotation and (6, ...) channels -> (6, ...)."""
    w = [sym_apply(o, (R[l, 0], R[l, 1], R[l, 2])) for l in range(3)]

    def entry(i, l):
        return R[i, 0] * w[l][0] + R[i, 1] * w[l][1] + R[i, 2] * w[l][2]

    return torch.stack([entry(i, l) for i, l in IDX])


def sym_from_diag_frame(V_cols, diag):
    """U diag(d) U^T -> (6, ...) channels.

    V_cols: three eigenvector 3-channel tuples (columns of U);
    diag: three scalar channels.
    """

    def entry(i, j):
        return sum(diag[k] * V_cols[k][i] * V_cols[k][j] for k in range(3))

    return torch.stack([entry(i, j) for i, j in IDX])


def rot_apply(R, v):
    """(3, 3) matrix applied to a 3-channel tuple -> 3-channel tuple."""
    return tuple(R[i, 0] * v[0] + R[i, 1] * v[1] + R[i, 2] * v[2] for i in range(3))
