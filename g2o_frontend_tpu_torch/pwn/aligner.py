"""PWN dense point-with-normal alignment (counterpart of
``g2o_frontend_tpu/pwn/aligner.py``).

Each outer Gauss-Newton iteration builds the 6x6 system from projective
association, the four correspondence gates and the robust point+normal
error; adds damping (1001 I) and priors; solves; and updates through the
quaternion chart ``invT <- v2t(dx) invT`` (``aligner.cpp:88-117``).
`_finalize_stats` then does the unscented remap, the information matrix
and the eigenratio/min-inlier validity gates (``aligner.cpp:128-199``).

Association:
- ``"auto"``, ``"fused"`` and ``"gather"`` take the exact projective gather
  (``ops/fused_aligner.fused_system``): the hand-written CUDA kernel on a
  CUDA tensor, its plain PyTorch version on a CPU tensor.
- ``"zbuffer"`` re-renders the reference with the two-pass z-buffer
  (reference parity) in plain PyTorch, then linearizes the associated
  planes with ``ops/linearizer.linearize_system``: the hand-written CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor.

Every inner iteration refreshes the association, as the JAX fused path
does; JAX's gather and z-buffer paths freeze it within an outer iteration,
which is the same at the default ``inner_iterations=1``.

A Gauss-Newton step of the gather associations without priors is
``ops/fused_aligner.fused_step``: on a CUDA tensor two launches, kernel 1
and the step kernel, which solves and updates invT on the card; on a CPU
tensor the plain system and the plain update. The z-buffer association and
priors take the plain update (`fused_aligner.gn_update`) on any device:
the z-buffer's system comes from the linearizer, not kernel 1, and the
prior system is re-linearised through ``jacfwd`` every iteration.
`align_batch` takes it too, on its K systems at once.

`align_batch` runs K alignments of candidate references against one shared
current cloud (the loop closer's batched candidate matching): one launch of
the batch kernel (``fused_aligner.fused_system_batch``) per Gauss-Newton
system, batched 6x6 solves and chart updates.

On a CUDA device each call of `align` or `align_batch` replays one CUDA
graph, captured once per key (``utils/graphs``; the counterpart of the JAX
functions' ``jax.jit``), and returns fresh clones of the graph's outputs,
as the JAX functions return fresh arrays. A numpy `initial_guess` is
copied to the device before the replay. The captured bodies are the
private `_align` and `_align_batch`, which run eagerly on the CPU; nothing
in them synchronises with the host (the solves use the ``_ex`` forms with
``check_errors=False``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import fused_aligner as _fa
from ..ops import linearizer as _lin
from ..ops.eigh3x3 import eigvals3x3
from ..utils import graphs, lie
from .cloud import Cloud
from .projector import PinholeProjector

ASSOCIATIONS = ("auto", "fused", "gather", "zbuffer")


@dataclass(frozen=True)
class AlignerConfig:
    """Defaults = reference constructor values (``aligner.cpp:14-37``,
    ``correspondencefinder.cpp:9-18``, ``linearizer.cpp:9-15``).

    ``band_dv``, ``band_du``, ``fused_min_band_coverage``, ``tile_rows`` and
    ``tile_cols`` tune the TPU kernel's banded window; they are accepted so
    that configs written for the JAX package still load, and are ignored:
    the CUDA kernel gathers every correspondence exactly.
    """

    outer_iterations: int = 10
    inner_iterations: int = 1
    inlier_distance_threshold: float = 0.5
    inlier_normal_angular_threshold: float = 0.866025  # cos(pi/6)
    flat_curvature_threshold: float = 0.02
    inlier_curvature_ratio_threshold: float = 1.3
    inlier_max_chi2: float = 9e3
    robust_kernel: bool = True
    damping: float = 1001.0
    translational_min_eigen_ratio: float = 50.0
    rotational_min_eigen_ratio: float = 50.0
    min_inliers: int = 100
    association: str = "auto"
    band_dv: int = 4
    band_du: int = 6
    fused_min_band_coverage: float = 0.90
    tile_rows: int = 32
    tile_cols: int = 128


class SE3Prior(NamedTuple):
    """Gaussian prior on the transform being estimated (``se3_prior.h:28-107``):
    error ``e(invT) = t2v(invT @ mean)`` with a constant mean matrix."""

    mean: torch.Tensor  # (4, 4), or (K, 4, 4) for K priors
    information: torch.Tensor  # (6, 6), or (K, 6, 6)


def absolute_prior(reference_transform, prior_mean, information) -> SE3Prior:
    """`SE3AbsolutePrior` (``se3_prior.h:85-106``) as an `SE3Prior`."""
    return SE3Prior(lie.se3_inverse(reference_transform) @ prior_mean, information)


def _prior_system(prior: SE3Prior, invT):
    """H, b contributions of one prior at invT (``aligner.cpp:96-108``);
    jacobians by forward-mode differentiation through the chart."""
    e = lie.se3_t2v(invT @ prior.mean)

    def err_left(eps):  # perturbation of the estimate: v2t(eps) * invT
        return lie.se3_t2v(lie.se3_v2t(eps) @ invT @ prior.mean)

    def err_mean(eps):  # perturbation of the prior mean: M * v2t(eps)
        return lie.se3_t2v(invT @ prior.mean @ lie.se3_v2t(eps))

    zero = torch.zeros(6, dtype=invT.dtype, device=invT.device)
    J = torch.func.jacfwd(err_left)(zero)
    Jz = torch.func.jacfwd(err_mean)(zero)
    # information remapped into the error space: Jz^-T Omega Jz^-1
    iJz = torch.linalg.inv_ex(Jz, check_errors=False).inverse
    omega_e = iJz.T @ prior.information @ iJz
    JtO = J.T @ omega_e
    return JtO @ J, JtO @ e


class AlignResult(NamedTuple):
    """One alignment; `align_batch` gives every field a leading K axis."""

    T: torch.Tensor  # (4, 4) current -> reference transform
    mean: torch.Tensor  # (6,) t2v mean of the solution distribution
    omega: torch.Tensor  # (6, 6) information of T in the t2v chart
    inliers: torch.Tensor  # () int32
    chi2: torch.Tensor  # () robust error at the optimum
    translational_ratio: torch.Tensor  # () eigenratio validity stats
    rotational_ratio: torch.Tensor
    valid: torch.Tensor  # () bool (eigenratio + min-inlier gates)
    band_coverage: torch.Tensor  # () always 1.0: the association is exact


def _correspondences_gather(ref: Cloud, cur: Cloud, invT, projector, cfg):
    """Exact projective gather association on clouds (the JAX function of
    the same name): returns (mask, rp, rn), rp/rn in the reference frame."""
    return _fa.gather_correspondences(
        cur.p, cur.n, cur.curv, cur.valid, _fa.pack_ref(ref), _fa.params_from_invT(invT),
        projector, cfg,
    )


def _linearize_planar(mask, rp, rn, cur: Cloud, invT, cfg):
    """Planar robust linearization: (H (6, 6), b (6,), chi2, inliers)."""
    sums = _fa.linearize_planar(mask, rp, rn, cur.p, cur.n, cur.op, cur.on, _fa.params_from_invT(invT), cfg)
    return _fa.unpack_sums(sums)


def _correspondences(ref: Cloud, cur: Cloud, invT, projector: PinholeProjector, cfg):
    """Z-buffer association: render the reference (mapped by invT into the
    current frame), take the winning reference attributes per pixel, apply
    the four gates. Returns (mask, ref_pts, ref_nrm) in the reference frame,
    trailing layout (H, W, 3)."""
    R, t = invT[:3, :3], invT[:3, 3]
    ref_in_cur = torch.einsum("ij,hwj->hwi", R, ref.points) + t
    _, idx = projector.project(ref_in_cur, ref.valid)
    hit = idx >= 0
    idx_safe = torch.clamp_min(idx, 0).to(torch.int64)
    ref_pts = ref.points.reshape(-1, 3)[idx_safe]
    ref_nrm = ref.normals.reshape(-1, 3)[idx_safe]
    ref_curv = ref.curv.reshape(-1)[idx_safe]

    ref_pts_cur = torch.einsum("ij,hwj->hwi", R, ref_pts) + t
    ref_nrm_cur = torch.einsum("ij,hwj->hwi", R, ref_nrm)
    cur_n = cur.normals
    cur_has_n = (cur_n * cur_n).sum(-1) > 0
    ref_has_n = (ref_nrm * ref_nrm).sum(-1) > 0
    dot = (cur_n * ref_nrm_cur).sum(-1)
    dist2 = ((cur.points - ref_pts_cur) ** 2).sum(-1)
    cthr = cfg.flat_curvature_threshold
    rc = torch.clamp_min(ref_curv, cthr)
    cc = torch.clamp_min(cur.curv, cthr)
    ratio = (rc + 1e-5) / (cc + 1e-5)
    mask = (
        hit
        & cur.valid
        & cur_has_n
        & ref_has_n
        & (dot >= cfg.inlier_normal_angular_threshold)
        & (dist2 <= cfg.inlier_distance_threshold**2)
        & (ratio >= 1.0 / cfg.inlier_curvature_ratio_threshold)
        & (ratio <= cfg.inlier_curvature_ratio_threshold)
    )
    return mask, ref_pts, ref_nrm


def _remap(ref_pts, ref_nrm, invT):
    """Associated reference points and normals (trailing layout, reference
    frame) mapped into the current frame: ((3, H, W), (3, H, W)), the
    planes ``linearizer.linearize_system`` takes."""
    R, t = invT[:3, :3], invT[:3, 3]
    p = torch.einsum("ij,hwj->ihw", R, ref_pts) + t[:, None, None]
    n = torch.einsum("ij,hwj->ihw", R, ref_nrm)
    return p.contiguous(), n.contiguous()


def _linearize(mask, ref_pts, ref_nrm, cur: Cloud, invT, cfg):
    """Masked H (6, 6), b (6,), chi2, inliers for e = invT*ref - cur
    (``linearizer.cpp:17-115``, asymmetric robust scaling)."""
    return _fa.unpack_sums(_lin.linearize_system(mask, *_remap(ref_pts, ref_nrm, invT), _fa.pack_cur(cur), cfg))


def _solve(A, B):
    return torch.linalg.solve_ex(A, B, check_errors=False).result


def _check_association(cfg):
    if cfg.association not in ASSOCIATIONS:
        raise ValueError(f"association must be one of {ASSOCIATIONS}, got {cfg.association!r}")


def align(
    reference: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guess=None,
    config: AlignerConfig = AlignerConfig(),
    priors: SE3Prior | None = None,
) -> AlignResult:
    """Estimate T (current -> reference) between two clouds on their device.

    `initial_guess` is a (4, 4) transform (tensor or array); `priors`
    optionally adds Gaussian transform priors (one `SE3Prior`, or one with a
    leading batch dimension) to every Gauss-Newton system. On a CUDA device
    the call replays the graph of its key (see the module docstring).
    """
    _check_association(config)
    if initial_guess is not None:
        initial_guess = torch.as_tensor(initial_guess, dtype=reference.p.dtype, device=reference.p.device)
    return _ALIGN(reference, current, projector, initial_guess, config, priors)


def _align(reference, current, projector, initial_guess, config, priors) -> AlignResult:
    """`align`'s body, run eagerly (the CPU) or captured (CUDA)."""
    cfg = config
    dtype, device = reference.p.dtype, reference.p.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    if initial_guess is None:
        T0 = torch.eye(4, dtype=dtype, device=device)
    else:
        T0 = torch.as_tensor(initial_guess, dtype=dtype, device=device)

    cur_packed = _fa.pack_cur(current)
    if cfg.association == "zbuffer":

        def system(invT):
            mask, ref_pts, ref_nrm = _correspondences(reference, current, invT, projector, cfg)
            return _fa.unpack_sums(_lin.linearize_system(mask, *_remap(ref_pts, ref_nrm, invT), cur_packed, cfg))

    else:
        ref_table = _fa.pack_ref(reference)

        def system(invT):
            sums = _fa.fused_system(cur_packed, ref_table, _fa.params_from_invT(invT), projector, cfg)
            return _fa.unpack_sums(sums)

    def add_priors(H, b, invT):
        if priors is None:
            return H, b
        means, infos = priors.mean, priors.information
        if means.ndim == 2:
            means, infos = means[None], infos[None]
        for mean, info in zip(means, infos):
            Hp, bp = _prior_system(SE3Prior(mean, info), invT)
            H, b = H + Hp, b + bp
        return H, b

    # step(invT, params, last) -> (invT, params); `last` re-orthonormalizes
    # through the chart (aligner.cpp:117)
    fused = cfg.association != "zbuffer" and priors is None
    if fused:

        def step(invT, params, last):
            return _fa.fused_step(cur_packed, ref_table, params, invT, projector, cfg, last)

    else:

        def step(invT, params, last):
            H, b, _, _ = system(invT)
            return _fa.gn_update(*add_priors(H + cfg.damping * eye6, b, invT), invT, last), None

    invT = lie.se3_inverse(T0)
    params = _fa.params_from_invT(invT) if fused else None
    for _ in range(cfg.outer_iterations):
        for i in range(cfg.inner_iterations):
            invT, params = step(invT, params, i == cfg.inner_iterations - 1)
        if not cfg.inner_iterations:  # no step re-orthonormalized: the chart alone, as JAX's loop does
            invT = lie.se3_v2t(lie.se3_t2v(invT))
    T = lie.se3_inverse(invT)

    # statistics at the optimum (aligner.cpp:152-199)
    H, b, chi2, inliers = system(invT)
    return _finalize_stats(T, H, chi2, inliers, cfg)


def align_batch(
    references: Cloud,
    current: Cloud,
    projector: PinholeProjector,
    initial_guesses,
    config: AlignerConfig = AlignerConfig(),
) -> AlignResult:
    """K alignments of stacked candidate references against ONE shared
    current cloud, on the clouds' device (the closer's batched candidate
    matching, ``pwn_closer.cpp:92-110`` done at once).

    `references` is a `Cloud` whose fields carry a leading K axis
    (`slam.pwn_matcher.stack_clouds`); `initial_guesses` is (K, 4, 4). The
    gather associations launch the batch kernel once per Gauss-Newton
    system (11 per call at the defaults); ``"zbuffer"`` runs K serial
    `align` calls. Returns an `AlignResult` with leading dim K; candidate k
    equals `align` of that pair. On a CUDA device the call replays the graph
    of its key (see the module docstring).
    """
    _check_association(config)
    T0 = torch.as_tensor(initial_guesses, dtype=current.p.dtype, device=current.p.device)
    return _ALIGN_BATCH(references, current, projector, T0, config)


def _align_batch(references, current, projector, initial_guesses, config) -> AlignResult:
    """`align_batch`'s body, run eagerly (the CPU) or captured (CUDA)."""
    cfg = config
    dtype, device = current.p.dtype, current.p.device
    T0 = torch.as_tensor(initial_guesses, dtype=dtype, device=device)
    if cfg.association == "zbuffer":
        results = [
            _align(Cloud(*(f[k] for f in references)), current, projector, T0[k], cfg, None)
            for k in range(T0.shape[0])
        ]
        return AlignResult(*(torch.stack(x) for x in zip(*results)))

    cur_packed = _fa.pack_cur(current)
    ref_tables = _fa.pack_ref(references)
    eye6 = torch.eye(6, dtype=dtype, device=device)

    def systems(invTs):
        sums = _fa.fused_system_batch(cur_packed, ref_tables, _fa.params_from_invT(invTs), projector, cfg)
        return _fa.unpack_sums(sums)

    invTs = lie.se3_inverse(T0)
    for _ in range(cfg.outer_iterations):
        for i in range(cfg.inner_iterations):
            H, b, _, _ = systems(invTs)
            invTs = _fa.gn_update(H + cfg.damping * eye6, b, invTs, i == cfg.inner_iterations - 1)
        if not cfg.inner_iterations:
            invTs = lie.se3_v2t(lie.se3_t2v(invTs))
    Ts = lie.se3_inverse(invTs)
    H, b, chi2, inliers = systems(invTs)
    return _finalize_stats(Ts, H, chi2, inliers, cfg)


def _finalize_stats(T, H, chi2, inliers, cfg) -> AlignResult:
    """Unscented remap of the local information to the chart at T, and the
    eigenratio validity gates (``aligner.cpp:152-199``). Every input may
    carry leading batch dimensions."""
    dtype, device = T.dtype, T.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    local_sigma = _solve(H + eye6, eye6)

    # unscented remap of N(0, local_sigma) through p -> t2v(T * v2t(p)^-1)
    dim = 6
    alpha, beta = 1e-3, 2.0
    lam_u = alpha * alpha * dim
    w0 = lam_u / (dim + lam_u)
    wi = 1.0 / (2.0 * (dim + lam_u))
    w0_cov = w0 + (1.0 - alpha * alpha + beta)
    L = torch.linalg.cholesky_ex((dim + lam_u) * local_sigma + 1e-9 * eye6, check_errors=False).L
    cols = L.transpose(-1, -2)  # rows are scaled columns of L
    zero = torch.zeros(L.shape[:-2] + (1, 6), dtype=dtype, device=device)
    pts = torch.cat([zero, cols, -cols], -2)  # (..., 13, 6)
    samples = lie.se3_t2v(T.unsqueeze(-3) @ lie.se3_inverse(lie.se3_v2t(pts)))
    wi_vec = torch.full((13,), wi, dtype=dtype, device=device)
    wp_vec = wi_vec.clone()
    wi_vec[:1].fill_(w0)  # fill_ takes the scalar on the device; item assignment copies it from the host
    wp_vec[:1].fill_(w0_cov)
    mean = (wi_vec[:, None] * samples).sum(-2)
    delta = samples - mean.unsqueeze(-2)
    sigma = torch.einsum("k,...ki,...kj->...ij", wp_vec, delta, delta)
    omega = _solve(sigma + 1e-9 * eye6, eye6)

    st = eigvals3x3(omega[..., :3, :3])
    sr = eigvals3x3(omega[..., 3:, 3:])
    tr_ratio = st[..., 2] / torch.clamp_min(st[..., 0], 1e-12)
    rr_ratio = sr[..., 2] / torch.clamp_min(sr[..., 0], 1e-12)
    valid = (
        (tr_ratio <= cfg.translational_min_eigen_ratio)
        & (rr_ratio <= cfg.rotational_min_eigen_ratio)
        & (inliers >= cfg.min_inliers)
    )
    coverage = torch.ones(T.shape[:-2], dtype=dtype, device=device)
    return AlignResult(T, mean, omega, inliers, chi2, tr_ratio, rr_ratio, valid, coverage)


_ALIGN = graphs.Stage("align", _align)
_ALIGN_BATCH = graphs.Stage("align_batch", _align_batch)
