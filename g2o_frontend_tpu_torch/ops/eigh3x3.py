"""Closed-form symmetric 3x3 eigendecomposition (counterpart of
``g2o_frontend_tpu/ops/eigh3x3.py``).

Trigonometric (Smith's) eigenvalues plus cross-product eigenvectors: pure
elementwise math over whole images, branchless. `eigvals3x3` takes trailing
(..., 3, 3) matrices (the aligner's 3x3 information blocks); the planar
functions take sym6 channels (6, ...) (the converter's covariances).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _eigvals(xx, xy, xz, yy, yz, zz):
    q = (xx + yy + zz) / 3.0
    b00, b11, b22 = xx - q, yy - q, zz - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (xy * xy + xz * xz + yz * yz) / 3.0
    p = torch.sqrt(p2 + _EPS)
    detB = b00 * (b11 * b22 - yz * yz) - xy * (xy * b22 - yz * xz) + xz * (xy * yz - b11 * xz)
    r = torch.clamp(detB / (2.0 * p * p * p + _EPS), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return e_lo, e_mid, e_hi


def eigvals3x3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending: (..., 3)."""
    lam = _eigvals(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2], A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    return torch.stack(lam, -1)


def eigvals3x3_planar(o):
    """Eigenvalues of sym6 channels (6, ...) -> 3 ascending scalar planes."""
    return _eigvals(*(o[k] for k in range(6)))


def _cross_t(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot_t(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _eigenvector_for_planar(o, lam, fallback):
    """Null direction of (A - lam I) via the largest row cross product."""
    xx, xy, xz, yy, yz, zz = (o[k] for k in range(6))
    r0 = (xx - lam, xy, xz)
    r1 = (xy, yy - lam, yz)
    r2 = (xz, yz, zz - lam)
    c01 = _cross_t(r0, r1)
    c02 = _cross_t(r0, r2)
    c12 = _cross_t(r1, r2)
    n01 = _dot_t(c01, c01)
    n02 = _dot_t(c02, c02)
    n12 = _dot_t(c12, c12)
    sel = n01 >= n02
    v = tuple(torch.where(sel, a, b) for a, b in zip(c01, c02))
    nbest = torch.maximum(n01, n02)
    sel2 = n12 > nbest
    v = tuple(torch.where(sel2, a, b) for a, b in zip(c12, v))
    nrm = torch.sqrt(_dot_t(v, v))
    ok = nrm > 1e-10
    inv = 1.0 / torch.clamp_min(nrm, _EPS)
    return tuple(torch.where(ok, vk * inv, fk) for vk, fk in zip(v, fallback))


def eigh3x3_planar(o):
    """Full decomposition of sym6 channels (6, ...).

    Returns (lam, V_cols): lam = 3 ascending eigenvalue planes; V_cols =
    three 3-channel eigenvector tuples (right-handed orthonormal frame).
    """
    lam = eigvals3x3_planar(o)
    z = torch.zeros_like(o[0])
    one = torch.ones_like(o[0])
    ez = (z, z, one)
    ex = (one, z, z)
    v0 = _eigenvector_for_planar(o, lam[0], ez)
    v1 = _eigenvector_for_planar(o, lam[1], ex)
    # orthogonalize v1 against v0, with a degenerate-case fallback
    d = _dot_t(v1, v0)
    v1 = tuple(v1[k] - d * v0[k] for k in range(3))
    n1 = torch.sqrt(_dot_t(v1, v1))
    alt = _cross_t(v0, ez)
    alt_n = torch.sqrt(_dot_t(alt, alt))
    alt2 = _cross_t(v0, ex)
    alt = tuple(torch.where(alt_n > 1e-6, a, b) for a, b in zip(alt, alt2))
    alt_inv = 1.0 / torch.clamp_min(torch.sqrt(_dot_t(alt, alt)), _EPS)
    alt = tuple(a * alt_inv for a in alt)
    ok1 = n1 > 1e-6
    inv1 = 1.0 / torch.clamp_min(n1, _EPS)
    v1 = tuple(torch.where(ok1, v1[k] * inv1, alt[k]) for k in range(3))
    v2 = _cross_t(v0, v1)
    return lam, (v0, v1, v2)
