"""SE(2) and SE(3) Lie maps in PyTorch (counterpart of
``g2o_frontend_tpu/utils/lie.py``).

The same charts as the JAX reference:

- the SE2 chart, 3-vector ``[x y theta]`` (``basemath/bm_se2.h``);
- the reference's quaternion chart, 6-vector ``[tx ty tz qx qy qz]`` with
  ``qw = sqrt(1 - |q_xyz|^2)`` (``basemath/bm_se3.h:8-51``);
- the canonical se(3) exp/log twist chart ``[v, w]``.

Every function takes leading batch dimensions (``(..., 3)``, ``(..., 3, 3)``,
``(..., 4, 4)``) where the JAX version is written for one element and
``vmap``-ed. Nothing synchronises with the host, and nothing writes in
place, so ``torch.func.jacfwd`` differentiates through the charts.
"""
from __future__ import annotations

import torch


# -- SE(2) ---------------------------------------------------------------------


def wrap_angle(th):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(th), torch.cos(th))


def se2_v2t(v):
    """(..., 3) [x, y, theta] -> (..., 3, 3) homogeneous transform."""
    c, s = torch.cos(v[..., 2]), torch.sin(v[..., 2])
    z, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [[c, -s, v[..., 0]], [s, c, v[..., 1]], [z, z, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def se2_t2v(T):
    """(..., 3, 3) homogeneous transform -> (..., 3) [x, y, theta]."""
    return torch.stack([T[..., 0, 2], T[..., 1, 2], torch.atan2(T[..., 1, 0], T[..., 0, 0])], -1)


def se2_compose(a, b):
    """a ⊕ b for chart vectors (..., 3): b applied in a's frame."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack(
        [a[..., 0] + c * b[..., 0] - s * b[..., 1], a[..., 1] + s * b[..., 0] + c * b[..., 1],
         wrap_angle(a[..., 2] + b[..., 2])],
        -1,
    )


def se2_inverse(a):
    """Inverse of chart vectors (..., 3)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(c * a[..., 0] + s * a[..., 1]), -(-s * a[..., 0] + c * a[..., 1]), -a[..., 2]], -1)


def se2_relative(a, b):
    """a^{-1} ∘ b as chart vectors (..., 3) (the SE2 edge prediction)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy, wrap_angle(b[..., 2] - a[..., 2])], -1)


def se2_apply(a, p):
    """Chart vectors (..., 3) applied to points (..., 2); `a` broadcasts
    against the points' leading dimensions."""
    c, s = torch.cos(a[..., 2:3]), torch.sin(a[..., 2:3])
    x = c * p[..., 0:1] - s * p[..., 1:2] + a[..., 0:1]
    y = s * p[..., 0:1] + c * p[..., 1:2] + a[..., 1:2]
    return torch.cat([x, y], -1)


# -- SE(3) ---------------------------------------------------------------------


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _norm(v, keepdim=False):
    # sqrt(sum v^2), as jnp.linalg.norm computes it
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def quat2mat(q_xyz):
    """Imaginary quaternion part (..., 3) -> rotation matrix (..., 3, 3).

    ``qw = sqrt(max(0, 1 - |q|^2))`` as in ``basemath/bm_se3.h:8-20``.
    """
    qx, qy, qz = q_xyz[..., 0], q_xyz[..., 1], q_xyz[..., 2]
    qw = torch.sqrt(torch.clamp_min(1.0 - (qx * qx + qy * qy + qz * qz), 0.0))
    rows = [
        [
            qw * qw + qx * qx - qy * qy - qz * qz,
            2 * (qx * qy - qw * qz),
            2 * (qx * qz + qw * qy),
        ],
        [
            2 * (qx * qy + qz * qw),
            qw * qw - qx * qx + qy * qy - qz * qz,
            2 * (qy * qz - qx * qw),
        ],
        [
            2 * (qx * qz - qy * qw),
            2 * (qy * qz + qx * qw),
            qw * qw - qx * qx - qy * qy + qz * qz,
        ],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def mat2quat_full(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion [qw, qx, qy, qz], qw >= 0.

    Branchless Shepperd's method: all four candidate quaternions are built
    and the one with the largest pivot is gathered, as in the reference.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # a tensor one, not the literal: under torch.func.jacfwd, python float +
    # 0-dim tensor gives a float64 tangent
    one = torch.ones_like(tr)
    qw_ = torch.stack([one + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx_ = torch.stack([m21 - m12, one + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy_ = torch.stack([m02 - m20, m01 + m10, one - m00 + m11 - m22, m12 + m21], -1)
    qz_ = torch.stack([m10 - m01, m02 + m20, m12 + m21, one - m00 - m11 + m22], -1)
    cands = torch.stack([qw_, qx_, qy_, qz_], -1)  # (..., 4 pivots, 4 comps)
    pivots = torch.stack(
        [one + tr, one + m00 - m11 - m22, one - m00 + m11 - m22, one - m00 - m11 + m22],
        -1,
    )
    best = torch.argmax(pivots, -1)[..., None, None].expand(pivots.shape[:-1] + (1, 4))
    q = torch.gather(cands, -2, best)[..., 0, :]
    q = q / _norm(q, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def mat2quat(R):
    """Rotation matrix -> imaginary quaternion part with qw >= 0
    (``bm_se3.h:23-33``)."""
    return mat2quat_full(R)[..., 1:]


def _hom(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4) homogeneous transform."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom = bottom + _eye(4, R)[3]
    return torch.cat([top, bottom], -2)


def se3_v2t(v):
    """6-vector [t, q_xyz] -> 4x4 transform (``bm_se3.h:35-42``)."""
    return _hom(quat2mat(v[..., 3:6]), v[..., 0:3])


def se3_t2v(T):
    """4x4 transform -> 6-vector [t, q_xyz] (``bm_se3.h:44-51``)."""
    return torch.cat([T[..., :3, 3], mat2quat(T[..., :3, :3])], -1)


def se3_compose(A, B):
    return A @ B


def se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _hom(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def skew(v):
    """(..., 3) -> canonical skew-symmetric (..., 3, 3) (no factor 2)."""
    z = torch.zeros_like(v[..., 0])
    rows = [
        [z, -v[..., 2], v[..., 1]],
        [v[..., 2], z, -v[..., 0]],
        [-v[..., 1], v[..., 0], z],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _sq(v):
    return (v * v).sum(-1)[..., None, None]


def so3_exp(w):
    """Axis-angle (..., 3) -> rotation matrix (Rodrigues), small-angle safe.

    The series branches cover th <= 1e-2: in float32 ``1 - cos th`` cancels
    catastrophically up to th ~ 3e-3, and the truncated series is ~1e-11
    relative there (the thresholds of the reference, ``lie.py:194-206``).
    """
    th2 = _sq(w)
    th = torch.sqrt(th2 + 1e-32)
    W = skew(w)
    a = torch.where(th2 > 1e-4, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(th2 > 1e-4, (1.0 - torch.cos(th)) / (th2 + 1e-32), 0.5 - th2 / 24.0)
    return _eye(3, w) + a * W + b * (W @ W)


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), safe near 0 and pi.

    The angle comes from atan2(|vee|, cos): arccos loses ~sqrt(eps) near 0.
    """
    tr = torch.clamp((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) * 0.5, -1.0, 1.0)
    v = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        -1,
    )
    s = _norm(v)
    th = torch.atan2(s, tr)[..., None]
    sin_th = torch.sin(th)
    generic = v * torch.where(sin_th > 1e-6, th / torch.clamp_min(sin_th, 1e-32), 1.0)
    diag = torch.clamp_min(
        (R.diagonal(dim1=-2, dim2=-1) - tr[..., None])
        / torch.clamp_min(1.0 - tr[..., None], 1e-12),
        0.0,
    )
    axis = torch.sqrt(diag) * torch.sign(torch.where(v != 0, v, 1.0))
    near_pi = axis / torch.clamp_min(_norm(axis, keepdim=True), 1e-12) * th
    return torch.where(th > 3.0, near_pi, generic)


def se3_exp(xi):
    """Twist (..., 6) [v, w] -> 4x4 transform."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    th2 = _sq(w)
    th = torch.sqrt(th2 + 1e-32)
    W = skew(w)
    b = torch.where(th2 > 1e-4, (1.0 - torch.cos(th)) / (th2 + 1e-32), 0.5 - th2 / 24.0)
    c = torch.where(
        th2 > 1e-4, (th - torch.sin(th)) / (th2 * th + 1e-32), 1.0 / 6.0 - th2 / 120.0
    )
    V = _eye(3, xi) + b * W + c * (W @ W)
    return _hom(R, (V @ v[..., None])[..., 0])


def se3_log(T):
    """4x4 transform -> twist (..., 6) [v, w].

    The series branch 1/12 + th^2/720 owns th <= 1e-2: with a smaller
    threshold ``1 - cos th`` rounds to 0 in float32 and the guarded division
    returns Inf (``lie.py:255-273``).
    """
    w = so3_log(T[..., :3, :3])
    th2 = _sq(w)
    th = torch.sqrt(th2 + 1e-32)
    W = skew(w)
    cot_term = torch.where(
        th2 > 1e-4,
        (1.0 - th * torch.sin(th) / (2.0 * torch.clamp_min(1.0 - torch.cos(th), 1e-32)))
        / (th2 + 1e-32),
        1.0 / 12.0 + th2 / 720.0,
    )
    Vinv = _eye(3, T) - 0.5 * W + cot_term * (W @ W)
    return torch.cat([(Vinv @ T[..., :3, 3:4])[..., 0], w], -1)


# -- quaternions, [w, x, y, z] on the last axis -----------------------------------


def quat_mul(a, b):
    """Hamilton product of (..., 4) [w, x, y, z] quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_rotate(q, p):
    """Rotate (..., 3) vectors p by the unit quaternion q = [w, x, y, z]."""
    w, xyz = q[..., :1], q[..., 1:]
    xyz = torch.broadcast_to(xyz, p.shape)
    t = 2.0 * torch.linalg.cross(xyz, p)
    return p + w * t + torch.linalg.cross(xyz, t)


def quat_normalize(q):
    """Unit quaternion(s) with w >= 0."""
    q = q / torch.clamp_min(_norm(q, keepdim=True), 1e-12)
    return torch.where(q[..., :1] < 0, -q, q)
