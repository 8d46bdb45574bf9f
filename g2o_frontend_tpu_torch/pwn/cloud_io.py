"""`.pwn` cloud file IO, the reference's on-disk cloud format (counterpart of
``g2o_frontend_tpu/pwn/cloud_io.py``; a file written by either package is
byte-equal to the other's and reads in both).

``pwn_core/cloud.cpp:25-137``: header line ``PWNCLOUD N binary``, a t2v
6-vector line for the stored sensor pose, then per-point records of
(point, normal, stats). ASCII records are ``POINTWITHSTATS`` + 3 + 3 + 16
floats (the Stats 4x4 matrix: columns 0-2 = covariance eigenvectors,
column 3 = the window mean as a homogeneous point). Binary records dump the
C++ structs: Point (4 floats, w=1), Normal (4 floats, w=0), Stats (the 4x4
matrix, 64 bytes, followed by the trailing members ``int _n``,
``Vector3f _eigenValues``, ``bool _curvatureComputed``, ``float _curvature``
padded to the struct's 16-byte alignment => 96 bytes, offsets 64/68/80/84).

The records are built in numpy on the host: a file is the host's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import sym6
from ..utils import lie
from .cloud import Cloud
from .converter import ConverterConfig

_STATS_BYTES = 96
_REC_BYTES = 16 + 16 + _STATS_BYTES


def save_pwn(path, cloud: Cloud, T=None, step: int = 1, binary: bool = True):
    """Write a Cloud (valid pixels only, every `step`-th) in the reference
    `.pwn` format, with the 4x4 sensor pose `T` (identity if None)."""
    valid = cloud.valid.reshape(-1).cpu().numpy()
    pts = cloud.p.reshape(3, -1).T.cpu().numpy()[valid][::step]
    nrm = cloud.n.reshape(3, -1).T.cpu().numpy()[valid][::step]
    ev = cloud.ev.reshape(3, -1).T.cpu().numpy()[valid][::step]
    evec = np.moveaxis(cloud.evec.reshape(3, 3, -1).cpu().numpy(), -1, 0)[valid][::step]  # (N, k, i)
    curv = cloud.curv.reshape(-1).cpu().numpy()[valid][::step]
    n = len(pts)

    T6 = np.zeros(6, np.float32)
    if T is not None:
        T6 = lie.se3_t2v(torch.as_tensor(np.asarray(T), dtype=torch.float32)).numpy()

    stats = np.zeros((n, 4, 4), np.float32)
    for k in range(3):
        stats[:, :3, k] = evec[:, k, :]  # column k = eigenvector k
    stats[:, :3, 3] = pts  # mean ~ point
    stats[:, 3, 3] = 1.0

    with open(path, "wb") as fh:
        fh.write(f"PWNCLOUD {n} {int(binary)}\n".encode())
        fh.write((" ".join(f"{v:g}" for v in T6) + " \n").encode())
        if not binary:
            lines = []
            for i in range(n):
                vals = list(pts[i]) + list(nrm[i]) + [stats[i, r, c] for r in range(4) for c in range(4)]
                lines.append("POINTWITHSTATS " + " ".join(f"{v:g}" for v in vals) + " ")
            fh.write(("\n".join(lines) + "\n").encode())
        else:
            rec = np.zeros((n, _REC_BYTES), np.uint8)
            rec[:, 0:12] = pts.astype("<f4").view(np.uint8).reshape(n, 12)
            rec[:, 12:16] = np.frombuffer(np.float32(1.0).tobytes(), np.uint8)  # point w = 1
            rec[:, 16:28] = nrm.astype("<f4").view(np.uint8).reshape(n, 12)
            # normal w = 0 (already zero); the stats matrix column-major (Eigen)
            mat = np.transpose(stats, (0, 2, 1)).reshape(n, 16)
            rec[:, 32:96] = mat.astype("<f4").view(np.uint8).reshape(n, 64)
            # trailing members: _n (int), _eigenValues, _curvatureComputed, _curvature
            rec[:, 96:100] = np.zeros((n, 1), "<i4").view(np.uint8)
            rec[:, 100:112] = ev.astype("<f4").view(np.uint8).reshape(n, 12)
            rec[:, 112] = 1  # curvatureComputed
            rec[:, 116:120] = curv.astype("<f4").view(np.uint8).reshape(n, 4)
            fh.write(rec.tobytes())


def load_pwn(path):
    """Read a `.pwn` file -> dict of (N, ...) numpy arrays + the stored pose T."""
    with open(path, "rb") as fh:
        header = fh.readline().split()
        if not header or header[0] != b"PWNCLOUD":
            raise ValueError(f"{path}: not a PWNCLOUD file")
        n, binary = int(header[1]), bool(int(header[2]))
        T6 = np.array([float(v) for v in fh.readline().split()], np.float32)
        T = lie.se3_v2t(torch.from_numpy(T6)).numpy()
        if binary:
            raw = np.frombuffer(fh.read(n * _REC_BYTES), np.uint8).reshape(n, _REC_BYTES)
            pts = raw[:, 0:12].copy().view("<f4").reshape(n, 3)
            nrm = raw[:, 16:28].copy().view("<f4").reshape(n, 3)
            mat = np.transpose(raw[:, 32:96].copy().view("<f4").reshape(n, 4, 4), (0, 2, 1))
            ev = raw[:, 100:112].copy().view("<f4").reshape(n, 3)
            curv = raw[:, 116:120].copy().view("<f4").reshape(n)
        else:
            pts = np.zeros((n, 3), np.float32)
            nrm = np.zeros((n, 3), np.float32)
            mat = np.zeros((n, 4, 4), np.float32)
            ev = np.zeros((n, 3), np.float32)  # ASCII stores no eigenvalues
            curv = np.zeros(n, np.float32)
            for i in range(n):
                tok = fh.readline().split()
                if not tok or tok[0] != b"POINTWITHSTATS":
                    continue
                vals = np.array([float(v) for v in tok[1:23]], np.float32)
                pts[i] = vals[0:3]
                nrm[i] = vals[3:6]
                mat[i] = vals[6:22].reshape(4, 4)
                curv[i] = 1.0  # no eigenvalues, so no curvature: lam0 / 0 reads as 1
    return {"points": pts, "normals": nrm, "stats": mat, "eigenvalues": ev, "curvature": curv, "T": T}


def cloud_from_pwn(path, config: ConverterConfig = ConverterConfig(), device="cuda") -> Cloud:
    """Load a `.pwn` file as a (1, N) image-organized Cloud on `device`,
    recomputing the information matrices from the stored eigen frames
    exactly as the converter does (``informationmatrixcalculator.cpp:9-59``)."""
    d = load_pwn(path)
    n = len(d["points"])

    def planes(a):  # (N, c) -> (c, 1, N)
        return torch.as_tensor(np.ascontiguousarray(a.T[:, None, :]), device=device)

    p, nrm, lam = planes(d["points"]), planes(d["normals"]), planes(d["eigenvalues"])
    curv = torch.as_tensor(d["curvature"][None, :], device=device)
    # eigenvector columns from the stats matrices
    V = tuple(tuple(torch.as_tensor(d["stats"][:, i, k][None, :], device=device) for i in range(3)) for k in range(3))
    flat = curv < config.curvature_threshold
    diag = tuple(torch.where(flat, config.point_flat_info[k], 1.0 / torch.clamp_min(lam[k], 1e-7)) for k in range(3))
    hn = ((nrm**2).sum(0) > 0).to(torch.float32)
    op = hn[None] * sym6.sym_from_diag_frame(V, diag)
    z = torch.zeros_like(curv)
    nf, nn = config.normal_flat_info, config.normal_nonflat_info
    on_diag = tuple(torch.where(flat, nf[k], nn[k]) * hn for k in range(3))
    on = torch.stack([on_diag[0], z, z, on_diag[1], z, on_diag[2]])
    evec = torch.stack([V[k][i] for k in range(3) for i in range(3)])
    return Cloud(p=p, n=nrm, curv=curv, ev=lam, evec=evec, op=op, on=on,
                 valid=torch.ones((1, n), dtype=torch.bool, device=device))
