"""Image-organized point-with-normal clouds, channel-planar (counterpart of
``g2o_frontend_tpu/pwn/cloud.py``).

Every per-point quantity is a tensor aligned with the depth image; invalid
pixels are masked, not compacted. The fields and their layouts are those of
the JAX `Cloud`, so the two packages compare field by field.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sym6


class Cloud(NamedTuple):
    """Per-pixel point-with-normal data (channel-planar).

    Attributes:
      p:     (3, H, W) 3D points in the cloud frame.
      n:     (3, H, W) unit normals; zero where undefined.
      curv:  (H, W) lam0/(lam0+lam1+lam2) surface curvature.
      ev:    (3, H, W) ascending local-covariance eigenvalues.
      evec:  (9, H, W) eigenvector frame; channel 3*k+i = component i of the
             k-th (ascending-eigenvalue) eigenvector.
      op:    (6, H, W) sym6 point information matrices.
      on:    (6, H, W) sym6 normal information matrices.
      valid: (H, W) bool — pixel has a valid unprojected point.
    """

    p: torch.Tensor
    n: torch.Tensor
    curv: torch.Tensor
    ev: torch.Tensor
    evec: torch.Tensor
    op: torch.Tensor
    on: torch.Tensor
    valid: torch.Tensor

    # trailing-layout views, read by the z-buffer association and the
    # matcher; a cloud stacked along leading axes keeps them in front
    @property
    def points(self):
        """(..., H, W, 3) points."""
        return self.p.movedim(-3, -1)

    @property
    def normals(self):
        """(..., H, W, 3) normals."""
        return self.n.movedim(-3, -1)

    @property
    def curvature(self):
        """(..., H, W) curvature."""
        return self.curv

    @property
    def eigenvalues(self):
        """(..., H, W, 3) ascending eigenvalues."""
        return self.ev.movedim(-3, -1)

    @property
    def eigenvectors(self):
        """(..., H, W, 3, 3), columns the eigenvectors."""
        V = self.evec.unflatten(-3, (3, 3))  # (..., k, i, H, W)
        return V.movedim((-4, -3), (-1, -2))

    @property
    def omega_p(self):
        """(H, W, 3, 3) point information matrices."""
        return sym6.sym_mat(self.op)

    @property
    def omega_n(self):
        """(H, W, 3, 3) normal information matrices."""
        return sym6.sym_mat(self.on)

    @property
    def shape(self):
        """(H, W) of the image grid."""
        return tuple(self.p.shape[-2:])

    def n_valid(self):
        return self.valid.sum()

    def transform(self, T) -> "Cloud":
        """Apply a 4x4 rigid transform to all geometric quantities."""
        R = T[:3, :3]
        t = T[:3, 3]
        pts = torch.stack(sym6.rot_apply(R, self.p)) + t[:, None, None]
        nrm = torch.stack(sym6.rot_apply(R, self.n))
        evec = torch.cat(
            [torch.stack(sym6.rot_apply(R, self.evec[3 * k : 3 * k + 3])) for k in range(3)]
        )
        op = sym6.sym_rotate(R, self.op)
        on = sym6.sym_rotate(R, self.on)
        return self._replace(p=pts, n=nrm, evec=evec, op=op, on=on)
