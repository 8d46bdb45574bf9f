"""Aligner Gauss-Newton systems: association + gates + robust linearization.

Counterpart of ``g2o_frontend_tpu/ops/pallas_aligner.py``: the Pallas
``_kernel`` reached through ``fused_linearize`` (one system) and
``_batch_kernel`` reached through ``fused_linearize_batch`` (K candidate
systems against one shared current cloud). For one ``invT`` a system is
exactly the JAX reference's ``_correspondences_gather`` followed by
``_linearize_planar``: 29 sums (Htt 6, Htr 9, Hrr 6, b 6, chi2, inliers) in
``_linearize_planar`` order.

- `fused_system` and `fused_system_batch` are the wrappers. On a CUDA
  tensor they launch the hand-written kernels of ``csrc/fused_aligner.cu``
  (or raise); on a CPU tensor they take the plain version. They count
  their kernel launches in `launches` and `batch_launches`.
- `fused_step` is one Gauss-Newton step of `pwn/aligner.align`: the system
  at `params`, damped, solved, and the pose updated through the chart. On
  a CUDA tensor it launches kernel 1 and the step kernel, which reduces
  kernel 1's block rows and writes the new invT and the next launch's
  params on the card; it counts the step in `step_launches` and kernel 1 in
  `launches`. On a CPU tensor it takes the plain version,
  `fused_system_reference` then `step_reference`.
- `step_reference` is the plain Gauss-Newton update on the 29 sums, and
  `gn_update` its solve and chart update alone (the aligner's plain tail,
  with the z-buffer association, priors and `align_batch`).
- `batch_layout` is the batch kernel's launch geometry (tiles of current
  pixels, candidate groups, scratch shape, limits), in Python so that the
  CPU tests reach it; `fused_system_batch` launches with it and rejects
  what it rejects, on any device.
- `_fused_system_batch_grid` launches the previous batch design, kept only
  as the batch kernel's timing yardstick.
- `fused_system_reference` is the plain PyTorch version on the same inputs:
  `gather_correspondences` + `linearize_planar`;
  `fused_system_batch_reference` is K of them.
- `pack_cur` / `pack_ref` lay the clouds out once per align: the current
  cloud as (20, H, W) planes, the reference as an (H*W, 8) f32 table
  [p(3), n(3), curv, valid] so that one exact gather is two 16 B loads;
  `pack_ref` of a stacked cloud gives (K, H*W, 8).
- `params_from_invT` and `unpack_sums` take leading batch dimensions and
  stay on the device (no host sync).

The TPU kernel's band machinery (per-tile window, bf16 pairs, tile starts,
coverage check) is not ported: the kernel gathers every correspondence
exactly. The kernel is built with nvcc at its first CUDA use, from the
package's own source, into ``_build/`` keyed by a hash of the source and
flags; importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..utils import lie
from . import cuda_build, sym6

N_SUMS = 29
C_CUR = 20
C_REF = 8
N_PARAMS = 24
# a Gauss-Newton step's state on the card: invT (16), params (24), dx (6), sums (29)
N_STATE = 16 + N_PARAMS + 6 + N_SUMS

# The batch kernel's geometry (csrc/fused_aligner.cu, pwn_terms.cuh): 128
# threads a block, 2 current pixels a thread, at most 8 candidates a block,
# the reference records of 2 candidates held in shared memory. `_load`
# holds the built library to the same threads, tile and group.
BATCH_THREADS = 128
BATCH_TILE = 2 * BATCH_THREADS
BATCH_MAX_GROUP = 8
BATCH_ROW_STAGES = 2
# Groups are sized so that the grid gives each of one H100's 132 SMs the 5
# blocks it holds at once where the candidates allow it.
FILL_BLOCKS = 5 * 132
MAX_K = 2**16 - 1  # the f64 reduction's grid (29, K)

# kernel launches made on CUDA tensors since the last reset: kernel 1 by
# `fused_system` and `fused_step` (one system), the batch kernel by
# `fused_system_batch` (K systems), the step kernel by `fused_step`
launches = 0
batch_launches = 0
step_launches = 0

SOURCE = cuda_build.CSRC / "fused_aligner.cu"
_lib = None


# -- layouts -------------------------------------------------------------------


def pack_cur(cloud):
    """Cloud -> (20, H, W) planes: p(0:3) n(3:6) curv(6) valid(7) op(8:14) on(14:20)."""
    dtype = cloud.p.dtype
    return torch.cat(
        [cloud.p, cloud.n, cloud.curv[None], cloud.valid[None].to(dtype), cloud.op, cloud.on]
    ).contiguous()


def pack_ref(cloud):
    """Cloud -> (H*W, 8) table: p(3), n(3), curv, valid per pixel; a cloud
    stacked along a leading K axis gives (K, H*W, 8)."""
    dtype = cloud.p.dtype
    d = cloud.p.ndim - 3  # leading batch dimensions
    planes = torch.cat([cloud.p, cloud.n, cloud.curv.unsqueeze(d), cloud.valid.unsqueeze(d).to(dtype)], d)
    return planes.reshape(planes.shape[:d] + (C_REF, -1)).transpose(-1, -2).contiguous()


def params_from_invT(invT):
    """invT (..., 4, 4) -> (..., 24) f32 [Rinv, tinv, R, t]: (Rinv, tinv) =
    invT^-1 maps current points into the reference camera, (R, t) = invT
    maps reference attributes into the current frame."""
    R = invT[..., :3, :3]
    t = invT[..., :3, 3]
    Rinv = R.transpose(-1, -2)
    tinv = -(Rinv @ t.unsqueeze(-1)).squeeze(-1)
    return torch.cat([Rinv.flatten(-2), tinv, R.flatten(-2), t], -1).to(torch.float32)


def _split(params):
    return params[0:9].reshape(3, 3), params[9:12], params[12:21].reshape(3, 3), params[21:24]


_SYM = [0, 1, 2, 1, 3, 4, 2, 4, 5]  # sym6 -> row-major 3x3


def _sym(v):
    # slices, not a list index: a list becomes a host tensor, which a CUDA
    # graph cannot capture (utils/graphs)
    return torch.stack([v[..., i] for i in _SYM], -1).unflatten(-1, (3, 3))


def unpack_sums(sums):
    """(..., 29) sums -> (H (..., 6, 6), b (..., 6), chi2 (...), inliers
    (...) int32)."""
    Htt, Htr, Hrr = _sym(sums[..., 0:6]), sums[..., 6:15].unflatten(-1, (3, 3)), _sym(sums[..., 15:21])
    H = torch.cat([torch.cat([Htt, Htr], -1), torch.cat([Htr.transpose(-1, -2), Hrr], -1)], -2)
    return H, sums[..., 21:27], sums[..., 27], sums[..., 28].to(torch.int32)


# -- the plain version -----------------------------------------------------------


def project_to_reference(cur_p, cur_valid, params, projector):
    """Project every current pixel's point into the reference image.

    Returns (inside (H, W) bool: the point is valid, within the depth range
    and lands in the image; idx (H, W) int64: the reference pixel v * W + u
    that `gather_correspondences` fetches, clamped into the image).
    """
    Rinv, tinv, _, _ = _split(params)
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
    return inside, torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)


def gather_correspondences(cur_p, cur_n, cur_curv, cur_valid, ref_table, params, projector, cfg):
    """For every current pixel: project into the reference image, fetch the
    reference point/normal/curvature there, apply the four gates.

    Returns (mask (H, W) bool, rp (3, H, W), rn (3, H, W)) with rp/rn in the
    reference frame (the JAX ``_correspondences_gather``).
    """
    _, _, R, t = _split(params)
    inside, idx = project_to_reference(cur_p, cur_valid, params, projector)
    got = ref_table[idx.reshape(-1)].T.reshape(C_REF, projector.rows, projector.cols)
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
    return linearize_remapped(mask, p, n, cur_p, cur_n, cur_op, cur_on, cfg)


def linearize_remapped(mask, p, n, cur_p, cur_n, op, on, cfg):
    """`linearize_planar` after the remap: p, n are the reference point and
    normal already mapped into the current frame, 3 planes each."""
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
    m = mask.to(p[0].dtype)
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


def fused_system_batch_reference(cur_packed, ref_tables, params, projector, cfg):
    """The plain PyTorch version of the batch kernel: K single systems."""
    return torch.stack(
        [fused_system_reference(cur_packed, table, prm, projector, cfg) for table, prm in zip(ref_tables, params)]
    )


def gn_update(A, b, invT, reorthonormalize):
    """Solve A dx = -b and update ``invT <- v2t(dx) invT`` through the
    quaternion chart, then, with `reorthonormalize`, ``invT <-
    v2t(t2v(invT))`` (``aligner.cpp:88-117``). A is the damped system; A,
    b and invT may share a leading batch axis (`align_batch`)."""
    dx = torch.linalg.solve_ex(A, -b[..., None], check_errors=False).result[..., 0]
    invT = lie.se3_v2t(dx) @ invT
    if reorthonormalize:
        invT = lie.se3_v2t(lie.se3_t2v(invT))
    return invT


def step_reference(sums, invT, damping, reorthonormalize):
    """The plain version of the step kernel: H and b of the (29,) sums,
    damping on the diagonal, `gn_update`. Returns (invT, params)."""
    H, b, _, _ = unpack_sums(sums)
    eye6 = torch.eye(6, dtype=invT.dtype, device=invT.device)  # the aligner's: the clouds' dtype
    invT = gn_update(H + damping * eye6, b, invT, reorthonormalize)
    return invT, params_from_invT(invT)


# -- the batch kernel's launch geometry ----------------------------------------------


def _ceil_div(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """The batch kernel's grid for K candidates of an H x W image: block b
    takes tile ``b // n_groups`` of `tile` current pixels and candidate
    group ``b % n_groups`` of `group` candidates (the last group may be
    short); thread t of a block takes pixels ``base + q * BATCH_THREADS + t``
    of its tile. Each block writes one row of the (K, n_tiles, 29)
    scratch for each of its candidates."""

    H: int
    W: int
    K: int
    tile: int
    n_tiles: int
    group: int
    n_groups: int

    @property
    def blocks(self):
        return self.n_tiles * self.n_groups

    @property
    def scratch_shape(self):
        return (self.K, self.n_tiles, N_SUMS)

    @property
    def smem_bytes(self):
        """Shared memory a block takes: its threads' fetched reference
        records, the tile's planes, its candidates' params rows, one 32-value
        row per (candidate, warp)."""
        records = BATCH_ROW_STAGES * self.tile * 4 * C_REF
        return records + 4 * (C_CUR * self.tile + self.group * (N_PARAMS + BATCH_THREADS))

    def pixels(self, b):
        """The current pixels block b sums, as the kernel's threads take them."""
        base = b // self.n_groups * self.tile
        local = np.arange(self.tile // BATCH_THREADS)[:, None] * BATCH_THREADS + np.arange(BATCH_THREADS)
        pix = base + local.reshape(-1)
        return pix[pix < self.H * self.W]

    def candidates(self, b):
        """The candidates block b sums."""
        k0 = b % self.n_groups * self.group
        return range(k0, min(k0 + self.group, self.K))


def batch_layout(H, W, K):
    """The batch kernel's `BatchLayout` for K candidates of an H x W image.

    Raises ValueError for K < 1, K beyond the reduction's grid (`MAX_K`),
    or an image or K tables beyond the kernel's int32 indexing, which also
    keeps the grid's block count in range. Groups take at most
    `BATCH_MAX_GROUP` candidates and are as many as the card needs to fill
    (`FILL_BLOCKS`), at most K.
    """
    n = H * W
    if K < 1:
        raise ValueError(f"the batch kernel needs at least one candidate, got K = {K}")
    if K > MAX_K:
        raise ValueError(f"K = {K} candidates exceed the batch kernel's grid (at most {MAX_K})")
    if not 0 < C_CUR * n < 2**31:
        raise ValueError(f"image size {H}x{W} out of the kernel's int32 range")
    if K * n * C_REF >= 2**31:
        raise ValueError(f"{K} candidates of {H}x{W} out of the kernel's int32 range")
    n_tiles = _ceil_div(n, BATCH_TILE)
    n_groups = min(K, max(_ceil_div(K, BATCH_MAX_GROUP), _ceil_div(FILL_BLOCKS, n_tiles)))
    group = _ceil_div(K, n_groups)
    return BatchLayout(H, W, K, BATCH_TILE, n_tiles, group, _ceil_div(K, group))


# -- the kernels -----------------------------------------------------------------


def build():
    """Compile ``csrc/fused_aligner.cu`` unless that build exists. Returns
    (library path, seconds spent compiling, nvcc's diagnostics)."""
    return cuda_build.build(SOURCE)


_GEOMETRY_ARGS = [ctypes.c_float] * 12 + [ctypes.c_int, ctypes.c_void_p]


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.fused_aligner_blocks.argtypes = [ctypes.c_int]
        lib.fused_aligner_blocks.restype = ctypes.c_int
        lib.fused_aligner_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + _GEOMETRY_ARGS
        lib.fused_aligner_launch.restype = ctypes.c_int
        lib.fused_aligner_batch_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + _GEOMETRY_ARGS
        lib.fused_aligner_batch_launch.restype = ctypes.c_int
        lib.fused_aligner_batch_grid_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + _GEOMETRY_ARGS
        lib.fused_aligner_batch_grid_launch.restype = ctypes.c_int
        lib.fused_aligner_step_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int] + _GEOMETRY_ARGS
        )
        lib.fused_aligner_step_launch.restype = ctypes.c_int
        lib.gauss_newton_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_float,
                                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.gauss_newton_step_launch.restype = ctypes.c_int
        if lib.gauss_newton_state_floats() != N_STATE:
            raise RuntimeError(f"{SOURCE.name} has a step state of {lib.gauss_newton_state_floats()} floats, "
                               f"the wrapper {N_STATE}")
        built = (lib.fused_aligner_batch_threads(), lib.fused_aligner_batch_tile(), lib.fused_aligner_batch_max_group())
        if built != (BATCH_THREADS, BATCH_TILE, BATCH_MAX_GROUP):
            raise RuntimeError(f"{SOURCE.name} has batch threads, tile and group {built}, batch_layout "
                               f"{(BATCH_THREADS, BATCH_TILE, BATCH_MAX_GROUP)}")
        _lib = lib
    return _lib


def _check_tensors(dev, *named):
    """Each (name, tensor, shape) on `dev`, float32, of that shape and
    contiguous, or ValueError."""
    for name, x, shape in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the first input on {dev}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(cur_packed, ref_table, params, H, W, K=None, invT=None):
    dev = cur_packed.device
    lead = () if K is None else (K,)
    named = [
        ("cur_packed", cur_packed, (C_CUR, H, W)),
        ("ref_table", ref_table, lead + (H * W, C_REF)),
        ("params", params, lead + (N_PARAMS,)),
    ]
    if invT is not None:
        named.append(("invT", invT, (4, 4)))
    _check_tensors(dev, *named)
    if ref_table.data_ptr() % 16:
        raise ValueError("ref_table must be 16-byte aligned (float4 loads)")
    if not 0 < C_CUR * H * W < 2**31:
        raise ValueError(f"image size {H}x{W} out of the kernel's int32 range")
    if K is not None:
        batch_layout(H, W, K)


def _geometry(projector, cfg, dev):
    rthr = cfg.inlier_curvature_ratio_threshold
    return (
        projector.fx, projector.fy, projector.cx, projector.cy,
        projector.min_distance, projector.max_distance,
        cfg.inlier_normal_angular_threshold, cfg.inlier_distance_threshold**2,
        cfg.flat_curvature_threshold, 1.0 / rthr, rthr, cfg.inlier_max_chi2,
        int(bool(cfg.robust_kernel)), torch.cuda.current_stream(dev).cuda_stream,
    )


def _device_of(cur_packed, name):
    dev = cur_packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {dev}")
    return dev


def fused_system(cur_packed, ref_table, params, projector, cfg):
    """29 sums of one aligner system (see module docstring).

    cur_packed (20, H, W), ref_table (H*W, 8) and params (24,) are float32
    on one device. A CUDA tensor launches the kernel on the current stream
    and does not synchronise; a CPU tensor takes `fused_system_reference`.
    """
    global launches
    dev = _device_of(cur_packed, "fused_system")
    if dev.type == "cpu":
        return fused_system_reference(cur_packed, ref_table, params, projector, cfg)
    H, W = projector.rows, projector.cols
    _check(cur_packed, ref_table, params, H, W)
    lib = _load()
    with torch.cuda.device(dev):
        block_sums = torch.empty((lib.fused_aligner_blocks(H * W), N_SUMS), dtype=torch.float32, device=dev)
        out = torch.empty(N_SUMS, dtype=torch.float32, device=dev)
        err = lib.fused_aligner_launch(
            cur_packed.data_ptr(), ref_table.data_ptr(), params.data_ptr(),
            block_sums.data_ptr(), out.data_ptr(), H, W, *_geometry(projector, cfg, dev),
        )
    if err != 0:
        raise RuntimeError(f"fused_aligner kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _split_state(state):
    """A step kernel's (N_STATE,) state -> (invT (4, 4), params (24,), dx
    (6,), sums (29,)), views of it."""
    invT, params, dx, sums = state.split((16, N_PARAMS, 6, N_SUMS))
    return invT.view(4, 4), params, dx, sums


def fused_step(cur_packed, ref_table, params, invT, projector, cfg, reorthonormalize):
    """One Gauss-Newton step of `pwn/aligner.align` (see module docstring).

    cur_packed (20, H, W), ref_table (H*W, 8), params (24,) and invT (4, 4)
    are float32 on one device, params those of invT. Returns the new
    (invT (4, 4), params (24,)); with `reorthonormalize` (an outer
    iteration's last inner step) invT is re-orthonormalised through the
    chart. A CUDA tensor launches kernel 1 and the step kernel on the
    current stream and does not synchronise; a CPU tensor takes
    `fused_system_reference` and `step_reference`.
    """
    global launches, step_launches
    dev = _device_of(cur_packed, "fused_step")
    if dev.type == "cpu":
        sums = fused_system_reference(cur_packed, ref_table, params, projector, cfg)
        return step_reference(sums, invT, cfg.damping, reorthonormalize)
    H, W = projector.rows, projector.cols
    _check(cur_packed, ref_table, params, H, W, invT=invT)
    lib = _load()
    with torch.cuda.device(dev):
        block_sums = torch.empty((lib.fused_aligner_blocks(H * W), N_SUMS), dtype=torch.float32, device=dev)
        state = torch.empty(N_STATE, dtype=torch.float32, device=dev)
        err = lib.fused_aligner_step_launch(
            cur_packed.data_ptr(), ref_table.data_ptr(), params.data_ptr(), invT.data_ptr(),
            block_sums.data_ptr(), state.data_ptr(), H, W, cfg.damping, int(bool(reorthonormalize)),
            *_geometry(projector, cfg, dev),
        )
    if err != 0:
        raise RuntimeError(f"fused_aligner step launch failed: CUDA error {err}")
    launches += 1
    step_launches += 1
    return _split_state(state)[:2]


def fused_system_batch(cur_packed, ref_tables, params, projector, cfg):
    """(K, 29) sums of K aligner systems against one shared current cloud.

    cur_packed (20, H, W), ref_tables (K, H*W, 8) and params (K, 24) are
    float32 on one device. Row k equals `fused_system_reference` of
    candidate k. K and the image must fit `batch_layout` on any device. A
    CUDA tensor launches the batch kernel on the current stream and does not
    synchronise; a CPU tensor takes `fused_system_batch_reference`.
    """
    global batch_launches
    dev = _device_of(cur_packed, "fused_system_batch")
    H, W = projector.rows, projector.cols
    layout = batch_layout(H, W, ref_tables.shape[0])
    if dev.type == "cpu":
        return fused_system_batch_reference(cur_packed, ref_tables, params, projector, cfg)
    _check(cur_packed, ref_tables, params, H, W, layout.K)
    lib = _load()
    with torch.cuda.device(dev):
        block_sums = torch.empty(layout.scratch_shape, dtype=torch.float32, device=dev)
        out = torch.empty((layout.K, N_SUMS), dtype=torch.float32, device=dev)
        err = lib.fused_aligner_batch_launch(
            cur_packed.data_ptr(), ref_tables.data_ptr(), params.data_ptr(),
            block_sums.data_ptr(), out.data_ptr(), layout.K, layout.group, H, W, *_geometry(projector, cfg, dev),
        )
    if err != 0:
        raise RuntimeError(f"fused_aligner batch kernel launch failed: CUDA error {err}")
    batch_launches += 1
    return out


def _fused_system_batch_grid(cur_packed, ref_tables, params, projector, cfg):
    """`fused_system_batch` by the previous batch design (one block per
    candidate and 256 pixels), on CUDA tensors only: the batch kernel's
    timing yardstick, on no user path and not counted."""
    dev = cur_packed.device
    if dev.type != "cuda":
        raise ValueError(f"the previous batch kernel runs on CUDA tensors, got {dev}")
    H, W = projector.rows, projector.cols
    K = ref_tables.shape[0]
    _check(cur_packed, ref_tables, params, H, W, K)
    lib = _load()
    n_blocks = lib.fused_aligner_blocks(H * W)
    if n_blocks >= 2**16:
        raise ValueError(f"image size {H}x{W} exceeds the previous batch kernel's grid")
    with torch.cuda.device(dev):
        block_sums = torch.empty((K, n_blocks, N_SUMS), dtype=torch.float32, device=dev)
        out = torch.empty((K, N_SUMS), dtype=torch.float32, device=dev)
        err = lib.fused_aligner_batch_grid_launch(
            cur_packed.data_ptr(), ref_tables.data_ptr(), params.data_ptr(),
            block_sums.data_ptr(), out.data_ptr(), K, H, W, *_geometry(projector, cfg, dev),
        )
    if err != 0:
        raise RuntimeError(f"previous fused_aligner batch kernel launch failed: CUDA error {err}")
    return out
