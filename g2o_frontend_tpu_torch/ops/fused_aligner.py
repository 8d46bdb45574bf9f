"""One aligner Gauss-Newton system: association + gates + robust linearization.

Counterpart of ``g2o_frontend_tpu/ops/pallas_aligner.py`` (the Pallas
``_kernel`` reached through ``fused_linearize``). For one ``invT`` it
computes exactly the JAX reference's ``_correspondences_gather`` followed by
``_linearize_planar`` and returns their 29 sums (Htt 6, Htr 9, Hrr 6, b 6,
chi2, inliers) in ``_linearize_planar`` order.

- `fused_system` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/fused_aligner.cu`` (or raises); on a CPU tensor
  it takes the plain version. It counts its kernel launches in `launches`.
- `fused_system_reference` is the plain PyTorch version on the same inputs:
  `gather_correspondences` + `linearize_planar`.
- `pack_cur` / `pack_ref` lay the clouds out once per align: the current
  cloud as (20, H, W) planes, the reference as an (H*W, 8) f32 table
  [p(3), n(3), curv, valid] so that one exact gather is two 16 B loads.
- `params_from_invT` and `unpack_sums` stay on the device (no host sync).

The TPU kernel's band machinery (per-tile window, bf16 pairs, tile starts,
coverage check) is not ported: the kernel gathers every correspondence
exactly. The kernel is built with nvcc at its first CUDA use, from the
package's own source, into ``_build/`` keyed by a hash of the source and
flags; importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import sym6

N_SUMS = 29
C_CUR = 20
C_REF = 8
N_PARAMS = 24

# kernel launches made by `fused_system` on CUDA tensors since the last reset
launches = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_aligner.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lib = None


# -- layouts -------------------------------------------------------------------


def pack_cur(cloud):
    """Cloud -> (20, H, W) planes: p(0:3) n(3:6) curv(6) valid(7) op(8:14) on(14:20)."""
    dtype = cloud.p.dtype
    return torch.cat(
        [cloud.p, cloud.n, cloud.curv[None], cloud.valid[None].to(dtype), cloud.op, cloud.on]
    ).contiguous()


def pack_ref(cloud):
    """Cloud -> (H*W, 8) table: p(3), n(3), curv, valid per pixel."""
    dtype = cloud.p.dtype
    planes = torch.cat([cloud.p, cloud.n, cloud.curv[None], cloud.valid[None].to(dtype)])
    return planes.reshape(C_REF, -1).T.contiguous()


def params_from_invT(invT):
    """invT (4, 4) -> (24,) f32 [Rinv, tinv, R, t]: (Rinv, tinv) = invT^-1
    maps current points into the reference camera, (R, t) = invT maps
    reference attributes into the current frame."""
    R = invT[:3, :3]
    t = invT[:3, 3]
    Rinv = R.T
    tinv = -(Rinv @ t)
    return torch.cat([Rinv.reshape(-1), tinv, R.reshape(-1), t]).to(torch.float32)


def _split(params):
    return params[0:9].reshape(3, 3), params[9:12], params[12:21].reshape(3, 3), params[21:24]


def _sym(v):
    return torch.stack(
        [torch.stack([v[0], v[1], v[2]]), torch.stack([v[1], v[3], v[4]]), torch.stack([v[2], v[4], v[5]])]
    )


def unpack_sums(sums):
    """(29,) sums -> (H (6, 6), b (6,), chi2 (), inliers () int32)."""
    Htt, Htr, Hrr = _sym(sums[0:6]), sums[6:15].reshape(3, 3), _sym(sums[15:21])
    H = torch.cat([torch.cat([Htt, Htr], 1), torch.cat([Htr.T, Hrr], 1)], 0)
    return H, sums[21:27], sums[27], sums[28].to(torch.int32)


# -- the plain version -----------------------------------------------------------


def gather_correspondences(cur_p, cur_n, cur_curv, cur_valid, ref_table, params, projector, cfg):
    """For every current pixel: project into the reference image, fetch the
    reference point/normal/curvature there, apply the four gates.

    Returns (mask (H, W) bool, rp (3, H, W), rn (3, H, W)) with rp/rn in the
    reference frame (the JAX ``_correspondences_gather``).
    """
    Rinv, tinv, R, t = _split(params)
    qx, qy, qz = sym6.rot_apply(Rinv, (cur_p[0], cur_p[1], cur_p[2]))
    qx, qy, qz = qx + tinv[0], qy + tinv[1], qz + tinv[2]
    d = qz
    safe = torch.where(d == 0, 1e-9, d)
    u = qx / safe * projector.fx + projector.cx
    v = qy / safe * projector.fy + projector.cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    H, W = projector.rows, projector.cols
    inside = (
        cur_valid
        & (d > projector.min_distance)
        & (d < projector.max_distance)
        & (ui >= 0)
        & (ui < W)
        & (vi >= 0)
        & (vi < H)
    )
    idx = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
    got = ref_table[idx.reshape(-1)].T.reshape(C_REF, H, W)
    rp, rn = got[0:3], got[3:6]
    ref_curv, ref_ok = got[6], got[7] > 0

    rpc = sym6.rot_apply(R, (rp[0], rp[1], rp[2]))
    rpc = (rpc[0] + t[0], rpc[1] + t[1], rpc[2] + t[2])
    rnc = sym6.rot_apply(R, (rn[0], rn[1], rn[2]))
    cur_has_n = cur_n[0] ** 2 + cur_n[1] ** 2 + cur_n[2] ** 2 > 0
    ref_has_n = rn[0] ** 2 + rn[1] ** 2 + rn[2] ** 2 > 0
    dot = cur_n[0] * rnc[0] + cur_n[1] * rnc[1] + cur_n[2] * rnc[2]
    dist2 = sum((cur_p[k] - rpc[k]) ** 2 for k in range(3))
    cthr = cfg.flat_curvature_threshold
    rc = torch.clamp_min(ref_curv, cthr)
    cc = torch.clamp_min(cur_curv, cthr)
    ratio = (rc + 1e-5) / (cc + 1e-5)
    mask = (
        inside
        & ref_ok
        & cur_has_n
        & ref_has_n
        & (dot >= cfg.inlier_normal_angular_threshold)
        & (dist2 <= cfg.inlier_distance_threshold**2)
        & (ratio >= 1.0 / cfg.inlier_curvature_ratio_threshold)
        & (ratio <= cfg.inlier_curvature_ratio_threshold)
    )
    return mask, rp, rn


def linearize_planar(mask, rp, rn, cur_p, cur_n, cur_op, cur_on, params, cfg):
    """Masked robust point+normal linearization -> (29,) sums (the JAX
    ``_linearize_planar``): b and chi2 scale by sqrt(max_chi2/chi2) above
    max_chi2, H does not."""
    _, _, R, t = _split(params)
    p = sym6.rot_apply(R, (rp[0], rp[1], rp[2]))
    p = (p[0] + t[0], p[1] + t[1], p[2] + t[2])
    n = sym6.rot_apply(R, (rn[0], rn[1], rn[2]))
    op, on = cur_op, cur_on
    ep = tuple(p[k] - cur_p[k] for k in range(3))
    en = tuple(n[k] - cur_n[k] for k in range(3))
    wp = sym6.sym_apply(op, ep)
    wn = sym6.sym_apply(on, en)
    local_chi2 = sum(ep[k] * wp[k] for k in range(3)) + sum(en[k] * wn[k] for k in range(3))
    kscale = torch.where(
        local_chi2 > cfg.inlier_max_chi2,
        torch.sqrt(cfg.inlier_max_chi2 / torch.clamp_min(local_chi2, 1e-12)),
        1.0,
    )
    if not cfg.robust_kernel:
        mask = mask & (local_chi2 <= cfg.inlier_max_chi2)
        kscale = torch.ones_like(kscale)
    m = mask.to(rp.dtype)
    mk = m * kscale

    # columns of S(p) = -2 hat(p) and S(n) (the quaternion-chart jacobian)
    z = torch.zeros_like(p[0])
    s = [(z, -2 * p[2], 2 * p[1]), (2 * p[2], z, -2 * p[0]), (-2 * p[1], 2 * p[0], z)]
    tn = [(z, -2 * n[2], 2 * n[1]), (2 * n[2], z, -2 * n[0]), (-2 * n[1], 2 * n[0], z)]
    c = [sym6.sym_apply(op, sj) for sj in s]
    d = [sym6.sym_apply(on, tj) for tj in tn]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    rows = []
    rows += [m * ch for ch in op]  # Htt upper triangle (6)
    rows += [m * c[j][i] for i in range(3) for j in range(3)]  # Htr (9)
    rows += [m * (dot3(s[i], c[j]) + dot3(tn[i], d[j])) for i in range(3) for j in range(i, 3)]
    rows += [mk * wp[k] for k in range(3)]  # b_t
    crx = p[1] * wp[2] - p[2] * wp[1] + n[1] * wn[2] - n[2] * wn[1]
    cry = p[2] * wp[0] - p[0] * wp[2] + n[2] * wn[0] - n[0] * wn[2]
    crz = p[0] * wp[1] - p[1] * wp[0] + n[0] * wn[1] - n[1] * wn[0]
    rows += [2 * mk * crx, 2 * mk * cry, 2 * mk * crz]  # b_r
    rows += [mk * local_chi2, m]
    return torch.stack(rows).flatten(1).sum(1)


def fused_system_reference(cur_packed, ref_table, params, projector, cfg):
    """The plain PyTorch version of the kernel, on the kernel's inputs."""
    c = cur_packed
    mask, rp, rn = gather_correspondences(
        c[0:3], c[3:6], c[6], c[7] > 0, ref_table, params, projector, cfg
    )
    return linearize_planar(mask, rp, rn, c[0:3], c[3:6], c[8:14], c[14:20], params, cfg)


# -- the kernel ------------------------------------------------------------------


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the fused aligner kernel needs the CUDA toolkit")


def build():
    """Compile ``csrc/fused_aligner.cu`` into ``_build/<hash>/`` unless that
    build exists. Returns (library path, seconds spent compiling, nvcc's
    diagnostics)."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = _BUILD_DIR / key
    lib = out_dir / "libfused_aligner.so"
    if lib.is_file():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libfused_aligner.{os.getpid()}.tmp.so"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0, proc.stdout + proc.stderr


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.fused_aligner_blocks.argtypes = [ctypes.c_int]
        lib.fused_aligner_blocks.restype = ctypes.c_int
        lib.fused_aligner_launch.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 2
            + [ctypes.c_float] * 12
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.fused_aligner_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(cur_packed, ref_table, params, H, W):
    dev = cur_packed.device
    for name, x, shape in (
        ("cur_packed", cur_packed, (C_CUR, H, W)),
        ("ref_table", ref_table, (H * W, C_REF)),
        ("params", params, (N_PARAMS,)),
    ):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, cur_packed on {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ref_table.data_ptr() % 16:
        raise ValueError("ref_table must be 16-byte aligned (float4 loads)")
    if not 0 < C_CUR * H * W < 2**31:
        raise ValueError(f"image size {H}x{W} out of the kernel's int32 range")


def fused_system(cur_packed, ref_table, params, projector, cfg):
    """29 sums of one aligner system (see module docstring).

    cur_packed (20, H, W), ref_table (H*W, 8) and params (24,) are float32
    on one device. A CUDA tensor launches the kernel on the current stream
    and does not synchronise; a CPU tensor takes `fused_system_reference`.
    """
    global launches
    dev = cur_packed.device
    if dev.type == "cpu":
        return fused_system_reference(cur_packed, ref_table, params, projector, cfg)
    if dev.type != "cuda":
        raise ValueError(f"fused_system runs on CPU or CUDA tensors, got {dev}")
    H, W = projector.rows, projector.cols
    _check(cur_packed, ref_table, params, H, W)
    lib = _load()
    with torch.cuda.device(dev):
        block_sums = torch.empty((lib.fused_aligner_blocks(H * W), N_SUMS), dtype=torch.float32, device=dev)
        out = torch.empty(N_SUMS, dtype=torch.float32, device=dev)
        rthr = cfg.inlier_curvature_ratio_threshold
        err = lib.fused_aligner_launch(
            cur_packed.data_ptr(), ref_table.data_ptr(), params.data_ptr(),
            block_sums.data_ptr(), out.data_ptr(), H, W,
            projector.fx, projector.fy, projector.cx, projector.cy,
            projector.min_distance, projector.max_distance,
            cfg.inlier_normal_angular_threshold, cfg.inlier_distance_threshold**2,
            cfg.flat_curvature_threshold, 1.0 / rthr, rthr, cfg.inlier_max_chi2,
            int(bool(cfg.robust_kernel)), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_aligner kernel launch failed: CUDA error {err}")
    launches += 1
    return out
